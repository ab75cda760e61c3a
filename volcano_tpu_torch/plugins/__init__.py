"""Policy plugins, registered by name (pkg/scheduler/plugins/factory.go)."""

from ..framework.plugins import register_plugin_builder
from .binpack import BinpackPlugin
from .conformance import ConformancePlugin
from .drf import DrfPlugin
from .gang import GangPlugin
from .nodeorder import NodeOrderPlugin
from .predicates import PredicatesPlugin
from .priority import PriorityPlugin
from .proportion import ProportionPlugin

register_plugin_builder("gang", GangPlugin)
register_plugin_builder("priority", PriorityPlugin)
register_plugin_builder("drf", DrfPlugin)
register_plugin_builder("proportion", ProportionPlugin)
register_plugin_builder("predicates", PredicatesPlugin)
register_plugin_builder("nodeorder", NodeOrderPlugin)
register_plugin_builder("binpack", BinpackPlugin)
register_plugin_builder("conformance", ConformancePlugin)

__all__ = [
    "BinpackPlugin",
    "ConformancePlugin",
    "DrfPlugin",
    "GangPlugin",
    "NodeOrderPlugin",
    "PredicatesPlugin",
    "PriorityPlugin",
    "ProportionPlugin",
]
