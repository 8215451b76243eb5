"""``repro_torch.evalbench`` — the RouterBench-style evaluation harness
(PyTorch counterpart of ``repro.evalbench``).

  * **many-model pools** (``pools``) — corpora with enough models that no
    single one dominates the frontier;
  * **frontier sweeps + AIQ** (``metrics``) — λ-swept accuracy–cost
    frontiers collapsed to a scalar (Average Improvement in Quality: the
    normalized area under the frontier's upper envelope), plus the
    zero-router / best-single / random / oracle reference points;
  * **robustness scenarios** (``perturb``) — seeded paraphrase-style
    embedding drift and adversarial queries that flip routing decisions
    within a norm budget;
  * **harness** (``harness``) — every registered router family federated
    vs client-local over the scenarios, offline over splits or online
    through the ``FedLoop``.
"""
from repro_torch.evalbench.harness import (  # noqa: F401
    eval_scenarios,
    offline_routerbench,
    online_routerbench,
)
from repro_torch.evalbench.metrics import (  # noqa: F401
    aiq,
    reference_points,
    sweep,
)
from repro_torch.evalbench.perturb import (  # noqa: F401
    adversarial_queries,
    paraphrase_drift,
)
from repro_torch.evalbench.pools import (  # noqa: F401
    make_pool_corpus,
    pool_table,
)
