"""sydr_tpu: a GNSS software receiver framework on JAX accelerators.

Top-level convenience exports; see README.md for the architecture map.
"""

__version__ = "0.1.0"

from sydr_tpu.channels.runtime import TrackingConfig  # noqa: F401
from sydr_tpu.receiver.receiver import (  # noqa: F401
    Receiver,
    ReceiverConfig,
    PvtFix,
)
from sydr_tpu.receiver.session import (  # noqa: F401
    AcquisitionConfig,
    TrackingSession,
)
