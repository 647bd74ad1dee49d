"""Object memory: instance records, memory build, consolidation, persistence
and the localise query (counterpart of instance_based_loc_tpu.memory)."""

from .object_info import ObjectInfo  # noqa: F401
from .object_memory import ObjectMemory  # noqa: F401
from .detection import (Detections, ColorRegionDetector,  # noqa: F401
                        DepthRegionDetector)
