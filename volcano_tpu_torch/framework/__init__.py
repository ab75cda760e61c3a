"""Scheduling framework: session, statement, plugin host, configuration."""

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
from .framework import POD_GROUP_UNSCHEDULABLE, close_session, open_session
from .plugins import (
    get_action,
    get_plugin_builder,
    register_action,
    register_plugin_builder,
)
from .session import Event, EventHandler, Session
from .statement import Statement

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
    "close_session",
    "open_session",
    "get_action",
    "get_plugin_builder",
    "register_action",
    "register_plugin_builder",
    "Event",
    "EventHandler",
    "Session",
    "Statement",
]
