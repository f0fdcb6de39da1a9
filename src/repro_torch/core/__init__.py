"""repro_torch.core — Aggify: cursor-loop → custom-aggregate compilation
and its executors on torch tensors."""
from .aggify import (AggifyAnalysis, CustomAggregate, NotAggifyable,
                     RewrittenProgram, aggify, analyze_loop, build_aggregate,
                     check_applicability, exec_stmts, is_aggifyable)
from .aggregate import Aggregate, fold_moments, streaming
from .cfg import CFG, FETCH_STATUS
from .dataflow import analyze
from .executors import (agg_call_values, build_env, execute_agg_call,
                        fused_eligible, grouped_agg_call, run_aggify,
                        run_cursor, run_rewritten)
from .loop_ir import (Assign, BinOp, Call, Col, Const, CursorLoop, Expr,
                      ForLoop, If, InsertLocal, Program, Stmt, UnOp, Var,
                      Where, let, maximum, minimum, wrap)

__all__ = [
    "AggifyAnalysis", "CustomAggregate", "NotAggifyable", "RewrittenProgram",
    "aggify", "analyze_loop", "build_aggregate", "check_applicability",
    "exec_stmts", "is_aggifyable", "Aggregate", "fold_moments", "streaming",
    "CFG", "FETCH_STATUS", "analyze", "agg_call_values", "build_env",
    "execute_agg_call", "fused_eligible", "grouped_agg_call", "run_aggify",
    "run_cursor", "run_rewritten", "Assign", "BinOp", "Call", "Col", "Const",
    "CursorLoop", "Expr", "ForLoop", "If", "InsertLocal", "Program", "Stmt",
    "UnOp", "Var", "Where", "let", "maximum", "minimum", "wrap",
]
