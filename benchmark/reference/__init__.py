"""The benchmark's plain reference: frozen copies of the port's plain
path (preprocessing, the 8 fusion phases with the plain blending, the
pose math), and `step.py`, which drives them frame by frame from the
benchmark's own inputs."""
