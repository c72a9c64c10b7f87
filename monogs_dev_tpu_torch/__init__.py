"""monogs_dev_tpu_torch: the PyTorch/CUDA port of monogs_dev_tpu.

RGB-D Gaussian-splatting SLAM with Gauss-Newton tracking on one NVIDIA GPU.
The per-tile blend and the projection (where no map field asks for a
gradient) run in hand-written CUDA kernels (csrc/blend.cu, csrc/project.cu,
built with nvcc at first use); on a CPU the same functions run their plain
torch versions. The layout mirrors the JAX package:

  geometry/  SE(3)/SO(3) exp maps, projection matrices, spherical harmonics
  models/    intrinsics, fixed-capacity Gaussian map and its state surgery
  ops/       projection, binning, blend kernels, kNN
  core/      Gauss-Newton tracking, mapping, keyframe insertion, frontend,
             backend and the SLAM system
  data/      synthetic scenes (the JAX package's, or drawn here) and the
             real-data loaders
  utils/     config, logging, losses, timers
  eval/      ATE
"""

__version__ = "0.1.0"
