"""Query planner: lazy logical plans over the Dataset shuffle verbs.

Counterpart of ``sparkrdma_tpu.plan``. ``Dataset.plan()`` (or
:meth:`LogicalPlan.dataset` / :meth:`LogicalPlan.from_host_rows`) lifts
a dataset into a lazy DAG of shuffle-verb nodes; :class:`PlanExecutor`
optimizes it (pushdown, shuffle-output reuse, broadcast joins, stage
overlap: one ShuffleConf gate each) and runs it on a ShuffleManager. See
``plan/nodes.py`` for the node algebra and ``plan/optimizer.py`` for the
rewrites.
"""

from sparkrdma_tpu_torch.plan.executor import (PLAN_FIELDS,
                                               BroadcastBuildError,
                                               PlanExecutor, plan_line,
                                               reuse_shuffle_id)
from sparkrdma_tpu_torch.plan.nodes import (LogicalPlan, PlanNode,
                                            node_fingerprint)
from sparkrdma_tpu_torch.plan.optimizer import optimize

__all__ = [
    "LogicalPlan", "PlanNode", "PlanExecutor", "optimize",
    "node_fingerprint", "PLAN_FIELDS", "plan_line", "reuse_shuffle_id",
    "BroadcastBuildError",
]
