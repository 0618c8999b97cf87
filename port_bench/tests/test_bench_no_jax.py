"""Nothing the harness or its reference loads is JAX or the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's), and the reference loads nothing of the port."""
import json
import subprocess
import sys

from conftest import FOLDER

WALK = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in list(sys.modules)}})))
"""


def _top_level(imports):
    out = subprocess.run(
        [sys.executable, "-c", WALK.format(root=str(FOLDER.parent),
                                           imports=imports)],
        capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    names = _top_level(
        "import port_bench.run, port_bench.readings\n"
        "import port_bench.harness.bench, port_bench.harness.program\n"
        "import port_bench.reference.loop\n"
        "from port_bench.harness.registry import Registry\n"
        "r = Registry()\n"
        "[r.metric(m['name']) for m in r.bench['per_layer']]\n"
        "import deepqlearning_tpu_torch.learner.segment\n")
    assert not names & {"jax", "jaxlib", "flax", "deepqlearning_tpu"}
    assert "deepqlearning_tpu_torch" in names


def test_reference_loads_nothing_of_the_port():
    """The reference with its env and layer kinds' files loaded and used:
    their ``program`` builders import the port only when called."""
    names = _top_level(
        "import torch\n"
        "import port_bench.reference.loop\n"
        "from port_bench.reference.nets import Net\n"
        "from port_bench.harness.registry import Registry\n"
        "r = Registry()\n"
        "for w in r.bench['workloads']:\n"
        "    c = r.config(w['config'])\n"
        "    env = r.env(c['env']['kind']).Reference(c['env'], 'cpu')\n"
        "    Net(c['net'], r, env.obs_shape)\n")
    assert not names & {"jax", "deepqlearning_tpu",
                        "deepqlearning_tpu_torch"}


def test_run_refuses_without_a_card():
    """Without CUDA the command exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, str(FOLDER / "run.py"), "--workload",
         "grid_mlp.grouped", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and not out.stdout.strip()
