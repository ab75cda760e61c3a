"""Session-level constants the fast path shares with the object session
(``framework/framework.go``): the PodGroup condition type written when a
gang cannot be scheduled."""

POD_GROUP_UNSCHEDULABLE = "Unschedulable"
