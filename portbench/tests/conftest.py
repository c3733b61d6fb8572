"""The benchmark's CPU tests run with several workers on a shared host: two
threads a worker keep them from crowding each other out."""

import torch

torch.set_num_threads(2)
