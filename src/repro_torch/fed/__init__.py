"""Online federation runtime: serve → harvest → federate → hot-swap
(PyTorch counterpart of ``repro/fed``).

  * ``aggregators`` — server-side aggregation strategies for the FedAvg
    round: plain weighted FedAvg, pairwise-masked secure aggregation,
    central-DP noise, the Byzantine-robust trimmed mean, median and
    norm clip, and buffered-async aggregation.
  * ``harvest`` — bounded per-client ``EvalBuffer``s fed by live serving
    (``RoutedServer(harvest=...)``) and their stacked federated view.
  * ``faults`` — the seeded ``FaultPlan`` and the ``CorruptUpdates``
    wrapper that applies Byzantine corruption inside the fit.

Not ported yet: the ``FedLoop`` scheduler with ``personalize_client``
(``repro/fed/loop.py``) and the traffic scenarios (``repro/fed/
scenarios.py``). Their names raise ``NotImplementedError``.
"""
from repro_torch.fed.aggregators import (Aggregator, BufferedAsyncAggregator,
                                         FedAvgAggregator,
                                         GaussianDPAggregator,
                                         MedianAggregator,
                                         NormClipAggregator,
                                         SecureAggAggregator,
                                         TrimmedMeanAggregator)
from repro_torch.fed.faults import CorruptUpdates, FaultPlan
from repro_torch.fed.harvest import EvalBuffer, HarvestStore

__all__ = [
    "Aggregator", "FedAvgAggregator", "GaussianDPAggregator",
    "SecureAggAggregator", "TrimmedMeanAggregator", "MedianAggregator",
    "NormClipAggregator", "BufferedAsyncAggregator",
    "FaultPlan", "CorruptUpdates", "EvalBuffer", "HarvestStore",
]

_NOT_PORTED = {
    "FedLoop": "loop", "FedLoopConfig": "loop", "personalize_client": "loop",
    "ScenarioConfig": "scenarios", "TrafficScenario": "scenarios",
    "run_online_vs_frozen": "scenarios", "PowerLawScenario": "scenarios",
}


def __getattr__(name):
    mod = _NOT_PORTED.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.fed' has no attribute {name!r}")
    raise NotImplementedError(
        f"repro_torch.fed.{name} (repro/fed/{mod}.py) is not ported yet: "
        "the FedLoop scheduler and the traffic scenarios are slice 10 of "
        "the port")
