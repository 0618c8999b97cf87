"""The plain reference of the benchmark's check: double-Q dueling DQN with
prioritized replay in plain PyTorch. It imports nothing of the measured
program and takes nothing it made, apart from the state it starts from."""
