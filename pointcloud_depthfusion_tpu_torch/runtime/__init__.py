"""The native host runtime (ctypes over ``csrc/host/pdf_runtime.cpp`` and
``csrc/host/temporal.cpp``): the OpenMP scene renderer, the rs2 spatial and
decimation filters, the camera node's temporal step, the ApproximateTime
pairer and the SPSC frame ring. Built by g++ at first use,
never at import (see :mod:`.bindings`)."""

from pointcloud_depthfusion_tpu_torch.runtime.bindings import (  # noqa: F401
    NativePairer,
    NativeRing,
    decimation_filter_native,
    has_native_filters,
    is_available,
    load_library,
    render_scene_native,
    spatial_filter_native,
    temporal_filter_native,
)
