"""Scheduler framework pieces the fast path needs: the conf schema and
its parser, typed argument helpers, and the session constants."""

from .arguments import Arguments, get_action_args
from .conf import (
    DEFAULT_SCHEDULER_CONF,
    DEPLOYED_SCHEDULER_CONF,
    REBALANCE_SCHEDULER_CONF,
    Configuration,
    PluginOption,
    SchedulerConfiguration,
    Tier,
    parse_scheduler_conf,
)
from .framework import POD_GROUP_UNSCHEDULABLE

__all__ = [
    "Arguments",
    "get_action_args",
    "DEFAULT_SCHEDULER_CONF",
    "DEPLOYED_SCHEDULER_CONF",
    "REBALANCE_SCHEDULER_CONF",
    "Configuration",
    "PluginOption",
    "SchedulerConfiguration",
    "Tier",
    "parse_scheduler_conf",
    "POD_GROUP_UNSCHEDULABLE",
]
