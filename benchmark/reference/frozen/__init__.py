"""Frozen plain copies of the measured program's networks and of the
float32 glue around them (sampling, view states, cameras, the depth
batch's poses), taken when the benchmark was defined. Kernels are replaced
by their plain versions, the collectives by a world of one. Nothing here
imports the program: a later change to the program is held against these
copies, never against itself."""
