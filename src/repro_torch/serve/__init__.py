"""Online serving (counterpart of repro.serve): ServeEngine, MicroBatcher
and the replay harness."""
from repro_torch.serve.batcher import DEFAULT_BUCKETS, MicroBatcher
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.replay import ReplayReport, replay

__all__ = ["DEFAULT_BUCKETS", "MicroBatcher", "ServeEngine", "ReplayReport",
           "replay"]
