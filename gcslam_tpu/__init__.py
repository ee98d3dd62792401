"""gcslam_tpu — Geometric Compositional SLAM as one jitted JAX program.

A JAX/XLA/Pallas framework, run on NVIDIA GPUs, with the capabilities of the
reference GC-SLAM system (see SURVEY.md): a strict, branch-free, fixed-cost
information-geometric SLAM backend. The whole per-scan pipeline compiles to a
single jitted fixed-shape program; hypotheses are vmapped; the map is a
device-resident tiled atlas updated with scatter kernels; replay sweeps shard
over a `jax.sharding.Mesh`.

Import order matters: `gcslam_tpu.utils.xla` enables float64 support and must
be imported before any array is created. Importing this package does that.
"""

from gcslam_tpu.utils import xla as _xla  # noqa: F401  (side effect: enable x64)

__version__ = "0.1.0"
