"""Cross-cutting runtime utilities.

Copies of the reference's small infrastructure packages:
``pkg/spanstat``, ``pkg/backoff``, ``pkg/controller``, ``pkg/trigger``,
``pkg/completion``, ``pkg/revert``, ``pkg/option``, ``pkg/metrics``.
"""

from .backoff import Exponential
from .completion import Completion, WaitGroup
from .controller import Controller, ControllerManager, ControllerParams
from .option import DaemonConfig, IntOptions, OptionSpec
from .revert import RevertStack
from .spanstat import SpanStat
from .trigger import Trigger

__all__ = [
    "Exponential", "Completion", "WaitGroup", "Controller",
    "ControllerManager", "ControllerParams", "DaemonConfig", "IntOptions",
    "OptionSpec", "RevertStack", "SpanStat", "Trigger",
]
