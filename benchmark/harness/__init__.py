"""The harness: the traffic kinds' drivers (batch.py, live.py), the
program they drive (program.py), weights and audio from the seed, traces,
the arithmetic of the metrics and the check that decides correct."""
