"""Experience replay."""
