"""stereo_match_traditional_tpu — a dense stereo-matching engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
Asherchi/Stereo_Match_Traditional (five classical stereo pipelines: SAD, NCC,
ASW, AD-Census, CBLSM), running on a GPU (and on the CPU for tests):

* cost volumes are dense ``[D, H, W]`` float32 arrays (W contiguous),
* window sums run as banded matrix products,
* cross/rectangle aggregation is O(1)/pixel via summed-area tables,
* the ASW volume has a Pallas kernel on the Triton route
  (``ops.kernels.asw_pallas``),
* scanline (SGM) optimization is a ``lax.scan`` over image columns/rows,
* post-processing (LR-check, speckles, hole fill, median) is pure array math,
* multi-device scaling uses ``jax.sharding.Mesh`` + ``shard_map`` with halo
  exchange between devices (see ``stereo_match_traditional_tpu.parallel``).

Reference behavior citations in docstrings use ``file:line`` into the
upstream C++ tree (e.g. ``SAD/Sad.h:96-139``).
"""

__version__ = "0.1.0"

from stereo_match_traditional_tpu.config import (  # noqa: F401
    ADCensusConfig,
    ASWConfig,
    CBLSMConfig,
    CrossAggregatorParams,
    NCCConfig,
    SADConfig,
)
