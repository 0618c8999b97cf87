"""The JAX package's five examples (``examples/``) on the port.

Each module holds its example's configuration verbatim in ``config(...)``
and runs it with ``main(device=None, **overrides)``: ``device`` as
``DeepQLearningSolver`` takes it (``None`` is the card), ``overrides``
replace entries of the configuration (a value the example derives from
``max_steps`` follows an overridden ``max_steps``). ``main`` prints what the
JAX example prints and returns ``(solver, policy)``. Run one with ``python
-m deepqlearning_tpu_torch.examples.<name>``: ``cartpole_dqn``,
``drqn_tiger``, ``gridworld_dqn``, ``image_conv_dqn``,
``scale_4096_envs``.
"""
