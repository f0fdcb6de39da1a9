"""repro_torch.relational — columnar tables, logical plans and the query
engine on torch tensors."""
from .engine import execute
from .plan import (AggCall, Filter, GroupAgg, IterSpace, Join, Limit,
                   OrderBy, Plan, Project, Scan, push_filter, strip_order)
from .table import Table

__all__ = ["execute", "AggCall", "Filter", "GroupAgg", "IterSpace", "Join",
           "Limit", "OrderBy", "Plan", "Project", "Scan", "push_filter",
           "strip_order", "Table"]
