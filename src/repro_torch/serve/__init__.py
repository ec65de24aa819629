"""Online serving (counterpart of repro.serve): ServeEngine, MicroBatcher,
the replay harness and the offline-parity gate."""
from repro_torch.serve.batcher import DEFAULT_BUCKETS, MicroBatcher
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.parity import check_offline_parity
from repro_torch.serve.replay import ReplayReport, replay

__all__ = ["DEFAULT_BUCKETS", "MicroBatcher", "ServeEngine", "ReplayReport",
           "check_offline_parity", "replay"]
