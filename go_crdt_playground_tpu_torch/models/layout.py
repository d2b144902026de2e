"""Axis roles of packed-state fields, by field name.  Field names are
used because shapes alone are ambiguous when A == E.
"""

# trailing axis is the actor axis A (vv[R, A]-shaped)
ACTOR_AXIS_FIELDS = frozenset({"vv", "processed"})

# replica axis only (no trailing data axis)
REPLICA_ONLY_FIELDS = frozenset({"actor"})
