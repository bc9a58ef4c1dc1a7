"""The three-sample call stage: a tumor's, its relapse's and the normal's
observation files -> calls VCF -> FDR-filtered calls.

The call stage (``stage_call.Stage``: the window, its traced hooks, the
release of the port's state) with the three-sample draw
(``calls_input3.draw``) and the three-sample check (``check_call3``).  The
window repeats the program's ``call_generic`` over the three files, each
followed by ``control_fdr`` of its calls, as the call stage does.
"""

from __future__ import annotations

import time

from . import stage_call


class Stage(stage_call.Stage):
    def setup(self):
        from varlociraptor_tpu_torch.calling.call import CallOptions, call_generic
        from varlociraptor_tpu_torch.filtration.fdr import control_fdr
        from varlociraptor_tpu_torch.grammar.scenario import Scenario

        from . import calls_input, calls_input3

        self._call_generic, self._control_fdr = call_generic, control_fdr
        t = time.perf_counter()
        self.inputs = calls_input3.draw(self.config, self.seed)
        self.paths = calls_input.write_files(self.inputs, self.work / "obs")
        self.timings = {"inputs_s": time.perf_counter() - t}
        self.scenario = Scenario(self.config["scenario"])
        self.options = CallOptions(resolution=self.config["resolution"])
        t = time.perf_counter()
        self._call(self.work / "warmup.vcf", self.work / "warmup.fdr.vcf")
        self.timings["warmup_s"] = time.perf_counter() - t
        (self.work / "out").mkdir()

    def check(self):
        from ..reference import check_call3

        return check_call3.check(self.inputs, self.config, self.traffic, self.calls, self.seed)
