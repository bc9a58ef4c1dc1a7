"""The trio call stage under --full-prior: a child's and both parents'
observation files -> calls VCF -> FDR-filtered calls.

The call stage (``stage_call.Stage``: the window, its traced hooks, the
release of the port's state) with the trio's draw (``calls_input_trio``),
the program's ``CallOptions(full_prior=True)`` at the configuration's
resolution, and the trio's check (``check_trio``).  The window repeats the
program's ``call_generic`` over the three files, each followed by
``control_fdr`` of its calls, as the call stage does; each call builds its
own joint prior table, as a user's call does.

A program that builds the table cell by cell (``Prior.compute`` a cell,
about 0.5 ms each: some 8 minutes a call at the cell's 101^3 cells, before
its first window) cannot run the cell within a run: set-up gives its
warm-up call ``FIRST_CALL_S`` seconds (a program that builds the table over
the whole grid at once takes 15 to 32 s there on an H100's host, its
kernels' builds included) and refuses the program when the call outlasts
them, long before the run's own time limit.
"""

from __future__ import annotations

import contextlib
import signal
import time

from . import stage_call

FIRST_CALL_S = 60.0


@contextlib.contextmanager
def deadline(seconds, what):
    """Raise TimeoutError in the main thread where the block outlasts
    ``seconds`` of wall time."""
    def expired(signum, frame):
        raise TimeoutError(f"{what} outlasted {seconds:g} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


class Stage(stage_call.Stage):
    def setup(self):
        from varlociraptor_tpu_torch.calling.call import CallOptions, call_generic
        from varlociraptor_tpu_torch.filtration.fdr import control_fdr
        from varlociraptor_tpu_torch.grammar.scenario import Scenario

        from . import calls_input, calls_input_trio

        self._call_generic, self._control_fdr = call_generic, control_fdr
        t = time.perf_counter()
        self.inputs = calls_input_trio.draw(self.config, self.seed)
        self.paths = calls_input.write_files(self.inputs, self.work / "obs")
        self.timings = {"inputs_s": time.perf_counter() - t}
        self.scenario = Scenario(self.config["scenario"])
        self.options = CallOptions(resolution=self.config["resolution"],
                                   full_prior=self.config["full_prior"])
        t = time.perf_counter()
        with deadline(FIRST_CALL_S, "the warm-up call (its joint prior table, "
                                    "the kernels' builds, the windows)"):
            self._call(self.work / "warmup.vcf", self.work / "warmup.fdr.vcf")
        self.timings["warmup_s"] = time.perf_counter() - t
        (self.work / "out").mkdir()

    def check(self):
        from ..reference import check_trio

        return check_trio.check(self.inputs, self.config, self.traffic, self.calls, self.seed)
