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
  * ``loop`` — the ``FedLoop`` scheduler: federated refits over the
    harvested buffers interleaved with engine decode chunks, hot-swapping
    router state into the route path; ``save()``/``restore()`` checkpoint
    the whole loop for bit-identical crash recovery.
  * ``scenarios`` — traffic simulators (client heterogeneity, drift,
    stragglers, mid-run model onboarding, power-law populations, the
    engine-chaos schedule) and the online-vs-frozen comparison behind
    ``BENCH_fedloop.json``.

``loop`` and ``scenarios`` import the serving stack, so they are exposed
lazily — ``core/federated.py`` importing ``repro_torch.fed.aggregators``
for its default strategy stays cycle-free.
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
    "FedLoop", "FedLoopConfig", "personalize_client",
    "ScenarioConfig", "TrafficScenario", "run_online_vs_frozen",
    "PowerLawScenario",
]

_LAZY = {
    "FedLoop": "loop", "FedLoopConfig": "loop", "personalize_client": "loop",
    "ScenarioConfig": "scenarios", "TrafficScenario": "scenarios",
    "run_online_vs_frozen": "scenarios", "PowerLawScenario": "scenarios",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.fed' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"repro_torch.fed.{mod}"), name)
