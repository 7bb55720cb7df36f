from stereo_match_traditional_tpu.ops.kernels.asw_pallas import (  # noqa: F401
    asw_volume_pallas,
    resolve_use_pallas,
)
