"""Worker for the port's SIGKILL flight-ring round trip.

Writes ``count`` records into the ring at ``sys.argv[1]`` with the port's
``FlightRecorder``, then, without any flush, close or atexit, sends itself
``SIGKILL``. ``test_torch_metrics_plane.py`` reads the ring back with both
packages' ``read_flight``. The module is loaded from
``replay_tpu_torch/obs/blackbox.py`` by file path (it needs only the
standard library), so the process imports neither torch nor JAX.

    python tests/_torch/flight_kill_worker_torch.py RING COUNT
"""

import importlib.util
import os
import signal
import sys
from pathlib import Path

_BLACKBOX = Path(__file__).resolve().parents[2] / "replay_tpu_torch" / "obs" / "blackbox.py"


def load_blackbox():
    spec = importlib.util.spec_from_file_location("port_blackbox", _BLACKBOX)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses resolves the module through sys.modules
    spec.loader.exec_module(module)
    return module


def main() -> None:
    ring_path, count = sys.argv[1], int(sys.argv[2])
    recorder = load_blackbox().FlightRecorder(ring_path, capacity=64)
    for step in range(count):
        recorder.record({"event": "on_train_step", "step": step, "loss": 0.5 - step / 100.0})
    os.kill(os.getpid(), signal.SIGKILL)
    raise AssertionError("survived SIGKILL")


if __name__ == "__main__":
    main()
