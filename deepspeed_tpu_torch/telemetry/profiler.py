"""On-demand device profiling with ``torch.profiler``, duration-bounded and
race-safe.

A burn-rate alert or a flight-recorder trip tells an operator *when*
something went wrong; a device trace tells them *what the device was
doing*. Port of ``deepspeed_tpu/telemetry/profiler.py``, whose
``jax.profiler`` capture becomes a ``torch.profiler`` one with the same
semantics:

- ``POST /v1/debug/profile`` (serving gateway) starts a capture of a
  bounded duration; a second request while one is in flight gets 409.
- The training engine polls :meth:`TorchProfiler.maybe_capture` at its
  report interval, so a capture requested mid-run
  (``engine.request_profile(...)``) starts at a step boundary.

Traces land next to the flight dumps (the sink's ``output_path``), one
directory per capture (``torch_trace_<seq>_<tag>/``) holding one Chrome
trace (``capture.trace.json``, loadable in Perfetto). ``torch.profiler``
must start and stop on one thread (stopping from another crashes the
process), so each capture runs on a thread of its own: it starts the
profiler, waits out the duration or an early stop, stops and exports. It
records the CUDA activity of the whole device and, where the installed
torch offers it, the operators of every thread. Stopping is
belt-and-braces: the capture thread ends at its deadline AND :meth:`poll`
(called from the gateway pump / engine report path) stops an overdue
capture."""

import os
import threading
import time


class ProfileBusy(RuntimeError):
    """A capture is already in flight (HTTP surfaces map this to 409)."""


_MAX_DURATION_S = 120.0
TRACE_FILE = "capture.trace.json"


def _profile():
    """A ``torch.profiler.profile`` over the CPU and, with a card, CUDA,
    recording every thread's operators where this torch can."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig
        return profile(activities=acts,
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):  # an older torch: the calling thread's operators
        return profile(activities=acts)


class _Capture:
    """One capture on its own thread (start, wait, stop, export)."""

    def __init__(self, trace_dir, duration_s, on_done):
        self.dir = trace_dir
        self.deadline = float("inf")  # counted from the profiler's start (its first start is slow)
        self._duration_s = duration_s
        self._stop = threading.Event()
        self._started = threading.Event()
        self._on_done = on_done
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="telemetry-profile")

    def _run(self):
        prof = None
        try:
            prof = _profile()
            prof.start()
            self.deadline = time.monotonic() + self._duration_s
        except Exception as e:  # noqa: BLE001 — surfaced to start()'s caller
            self.error = e
            prof = None
        self._started.set()
        if prof is not None:
            self._stop.wait(self._duration_s)
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(self.dir, TRACE_FILE))
            except Exception as e:  # noqa: BLE001 — a failed stop must not
                self.error = e       # wedge the manager (the directory stays partial)
        self._on_done(self)

    def start(self):
        self.thread.start()
        self._started.wait()

    def stop(self, wait):
        """End the capture early; ``wait``: join the thread (stop + export)."""
        self._stop.set()
        if wait and threading.current_thread() is not self.thread:
            self.thread.join(60.0)


class TorchProfiler:
    """Duration-bounded ``torch.profiler`` capture manager (one per process
    surface: the gateway and the training engine each own one, writing under
    the same telemetry output path)."""

    def __init__(self, output_path):
        self.output_path = output_path
        self._lock = threading.Lock()
        self._active = None      # the _Capture in flight
        self._seq = 0
        self._pending = None     # requested duration awaiting a boundary
        self.captures = []       # directories of completed captures

    # ---------------------------------------------------------------- capture
    def start(self, duration_s=1.0, tag="ondemand"):
        """Begin a capture; returns the trace directory. Raises
        :class:`ProfileBusy` when one is already in flight."""
        duration_s = min(max(0.05, float(duration_s)), _MAX_DURATION_S)
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in str(tag))
        with self._lock:
            if self._active is not None:
                raise ProfileBusy(f"a profile capture is already in flight "
                                  f"({self._active.dir})")
            self._seq += 1
            trace_dir = os.path.join(self.output_path, f"torch_trace_{self._seq:03d}_{safe}")
            os.makedirs(trace_dir, exist_ok=True)
            cap = self._active = _Capture(trace_dir, duration_s, self._finished)
        cap.start()
        if cap.error is not None:  # the profiler never started: the thread is ending
            cap.thread.join(10.0)
            raise RuntimeError(f"profile capture failed to start: {cap.error}")
        return trace_dir

    def _finished(self, cap):
        with self._lock:
            if self._active is cap:
                self._active = None
            self.captures.append(cap.dir)

    def _stop_if_due(self, force=False):
        cap = self._active
        if cap is None:
            return None
        if not force and time.monotonic() < cap.deadline:
            return None
        cap.stop(wait=force)  # a poll from the pump does not wait for the export
        return cap.dir

    def poll(self):
        """Stop an overdue capture (cheap; call from pump/report loops).
        Returns the finished trace dir when this call stopped one."""
        if self._active is None:
            return None
        return self._stop_if_due(force=False)

    def stop(self):
        """Force-stop the in-flight capture (process shutdown)."""
        return self._stop_if_due(force=True)

    @property
    def active(self):
        a = self._active
        if a is None:
            return None
        return {"dir": a.dir, "deadline": a.deadline if a.deadline != float("inf") else None}

    # ------------------------------------------------------- training boundary
    def request(self, duration_s=1.0):
        """Ask for a capture at the next report boundary (training engine).
        Raises :class:`ProfileBusy` when one is in flight or pending."""
        with self._lock:
            if self._active is not None or self._pending is not None:
                raise ProfileBusy("a profile capture is already in flight or pending")
            self._pending = min(max(0.05, float(duration_s)), _MAX_DURATION_S)

    def maybe_capture(self, tag="report"):
        """Report-interval hook: start the pending capture, if any. Also
        stops an overdue one. Returns the trace dir when a capture began."""
        self.poll()
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return None
        return self.start(pending, tag=tag)


# the JAX package's name for the manager
XlaProfiler = TorchProfiler


def trace_artifacts(trace_dir):
    """The trace files under one capture directory — what the tests and
    the gateway response use to prove the capture is real."""
    out = []
    for root, _dirs, files in os.walk(trace_dir):
        for f in files:
            if f.endswith((".trace.json", ".trace.json.gz")):
                out.append(os.path.join(root, f))
    return sorted(out)
