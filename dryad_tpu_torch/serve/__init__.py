"""dryad_tpu_torch.serve: online inference on the port's bitwise predict.

    from dryad_tpu_torch.serve import PredictServer

    server = PredictServer()                    # the card; device="cpu" too
    server.load_model("model.dryad")            # npz or text, either package
    server.warmup()                             # capture every bucket's graph
    preds = server.predict(X_rows)              # == Booster.predict, bitwise
    server.stats()                              # latency, batching, cache

Layers (one module each):

* registry.py: versioned and named models, hot swap and rollback, device
  tables under an LRU memory budget
* cache.py:    the shape-bucketed predict cache (power-of-two row padding,
               one CUDA graph per (version, bucket) on the card)
* batcher.py:  the micro-batching queue: deadline coalescing,
               backpressure, per-request timeouts, the two-deep
               prepare/execute pipeline
* metrics.py:  counters and windowed latency histograms behind ``stats()``
* server.py:   PredictServer, tying them together
* http.py:     the stdlib HTTP front end (``python -m dryad_tpu_torch
               serve``)
* bench.py:    the closed-loop benchmark, pipeline against serial, packed
               against SoA
"""

from dryad_tpu_torch.serve.batcher import (MicroBatcher, Request,
                                           ServeOverloaded, ServeTimeout)
from dryad_tpu_torch.serve.bench import run_bench, run_bench_compare
from dryad_tpu_torch.serve.cache import (CompiledPredictCache,
                                         PreparedPredict, bucket_rows)
from dryad_tpu_torch.serve.metrics import ModelStats, ServeMetrics
from dryad_tpu_torch.serve.registry import ModelEntry, ModelRegistry
from dryad_tpu_torch.serve.server import PredictServer

__all__ = [
    "CompiledPredictCache", "MicroBatcher", "ModelEntry", "ModelRegistry",
    "ModelStats", "PredictServer", "PreparedPredict", "Request",
    "ServeMetrics", "ServeOverloaded", "ServeTimeout", "bucket_rows",
    "run_bench", "run_bench_compare",
]
