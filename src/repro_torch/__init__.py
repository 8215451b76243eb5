"""PyTorch / CUDA port of FedRoute's routed-serving path.

A second package beside the JAX reference (``src/repro``), with the same
module layout: ``repro_torch.models.attention`` is the counterpart of
``repro.models.attention``. It imports ``torch`` and numpy, never JAX or
the reference package. Every Pallas TPU kernel on the serving path is a
hand-written CUDA C++ kernel for Hopper (``kernels/csrc``), built with
``nvcc`` at first use and bound with ``ctypes``.

Entry points (``models.init_params``, ``serve.gateway.make_pool_model``,
``serve.gateway.RoutedServer``, ``serve.engine.ServeEngine`` and a
router's ``init``) run on the CUDA device unless the caller passes
``device="cpu"``; without a GPU and without ``device="cpu"`` they raise.
"""
