"""The agent daemon: composition root plus its REST API (``rest``).

Port of ``cilium_tpu/daemon`` (reference: daemon/ — NewDaemon bootstrap,
policy import/trigger, endpoint lifecycle, state restore, status).
"""

from .daemon import Daemon

__all__ = ["Daemon"]
