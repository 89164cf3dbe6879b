"""Index subsystem: on-disk storage, device layout, IVF build, create pipeline."""

from fast_plaid_tpu_torch.index.layout import (  # noqa: F401
    DeviceIndex,
    IndexSpec,
    to_device,
)
from fast_plaid_tpu_torch.index.storage import (  # noqa: F401
    IndexData,
    load_index_data,
)

__all__ = ["DeviceIndex", "IndexSpec", "to_device", "IndexData", "load_index_data"]
