"""Session identity (``framework/session.go``): the process-wide counter
that numbers scheduling sessions ``ssn-1``, ``ssn-2``, ...  The fast path
stamps each cycle's PodGroup conditions with its session uid."""

import itertools

_session_counter = itertools.count(1)
