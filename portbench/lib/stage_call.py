"""The call stage: observation files -> calls VCF -> FDR-filtered calls.

Set-up draws the configuration's candidates and reads from the seed (``calls_input.draw``), writes them
as the program's observation files, builds the program's ``Scenario`` from
the configuration, and warms the path up with one whole call.  The window
repeats the program's ``call_generic`` over the files, each followed by
``control_fdr`` of its calls at the configuration's events and FDR, until
a call completes after ``--seconds``.  Each call writes its own VCFs; the
wall and process CPU seconds at its end go into ``timings`` (``units_s``,
``units_cpu_s``).

Traced, the window also records K1's launch shapes through
``ll_classes.launch_hook``, a span around each ``PosteriorEngine.run_wire``
(the engine's host side), and the growth of the engines' grid-axis loop
steps (``PosteriorEngine.loop_steps`` of the call stage's engine cache).
"""

from __future__ import annotations

import time

from .trace import span


class Stage:
    def __init__(self, config, traffic, seed, work, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.work, self.device = work, device

    def setup(self):
        from varlociraptor_tpu_torch.calling.call import CallOptions, call_generic
        from varlociraptor_tpu_torch.filtration.fdr import control_fdr
        from varlociraptor_tpu_torch.grammar.scenario import Scenario

        self._call_generic, self._control_fdr = call_generic, control_fdr
        from . import calls_input

        t = time.perf_counter()
        self.inputs = calls_input.draw(self.config, self.seed)
        self.paths = calls_input.write_files(self.inputs, self.work / "obs")
        self.timings = {"inputs_s": time.perf_counter() - t}
        self.scenario = Scenario(self.config["scenario"])
        self.options = CallOptions(resolution=self.config["resolution"])
        t = time.perf_counter()
        self._call(self.work / "warmup.vcf", self.work / "warmup.fdr.vcf")
        self.timings["warmup_s"] = time.perf_counter() - t
        (self.work / "out").mkdir()

    def _call(self, vcf, fdr_vcf):
        fdr = self.config["fdr"]
        with span("call_generic"):
            n = self._call_generic(self.scenario, self.paths, str(vcf), self.options,
                                   device=self.device)
        with span("control_fdr"):
            self._control_fdr(str(vcf), str(fdr_vcf), events=fdr["events"],
                              alpha=fdr["alpha"])
        return n

    def window(self, seconds, traced):
        from varlociraptor_tpu_torch.calling import call
        from varlociraptor_tpu_torch.ops import ll_classes, posterior

        rec = {"k1_launches": []}
        run_wire = posterior.PosteriorEngine.run_wire
        if traced:
            def spanned_run_wire(engine, *args, **kw):
                with span("engine"):
                    return run_wire(engine, *args, **kw)

            ll_classes.launch_hook = lambda N, U, D: rec["k1_launches"].append((N, U, D))
            posterior.PosteriorEngine.run_wire = spanned_run_wire
        steps0 = sum(e.loop_steps for e in call._GLOBAL_ENGINES.values())
        self.calls, loci, k = [], 0, 0
        try:
            t0, c0 = time.perf_counter(), time.process_time()
            while True:
                vcf = self.work / "out" / f"{k:04d}.vcf"
                fdr_vcf = self.work / "out" / f"{k:04d}.fdr.vcf"
                loci += self._call(vcf, fdr_vcf)
                self.calls.append((vcf, fdr_vcf))
                self.timings.setdefault("units_s", []).append(time.perf_counter() - t0)
                self.timings.setdefault("units_cpu_s", []).append(time.process_time() - c0)
                k += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            wall = time.perf_counter() - t0
        finally:
            ll_classes.launch_hook = None
            posterior.PosteriorEngine.run_wire = run_wire
        rec.update(units=loci, window_s=wall, calls=k,
                   loop_steps=sum(e.loop_steps for e in call._GLOBAL_ENGINES.values())
                   - steps0)
        return rec

    def release(self):
        """Drop the port's state (its engines and their device tables) before
        the reference runs."""
        from varlociraptor_tpu_torch.calling import call

        call._GLOBAL_ENGINES.clear()
        self.scenario = self._call_generic = None

    def check(self):
        from ..reference import check_call

        return check_call.check(self.inputs, self.config, self.traffic, self.calls, self.seed)
