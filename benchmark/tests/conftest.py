"""Few torch threads a test worker: pytest-xdist runs several workers, and
torch's default of one thread a core in each makes them wait on each other."""
import torch

torch.set_num_threads(2)
