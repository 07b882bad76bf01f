"""``rrl_runs``: a closed loop of RRL RT runs, one client; a request sets
the model's epoch and asks ``JetModel.rrl_rt_products(line, channels,
contsub=..., as_numpy=True)``.  Keys: ``line``, ``channels`` (about the
line's rest frequency), ``contsub``, ``epochs_yr``, ``sample_runs``,
``trace_requests``."""
from benchmark.harness.workloads import Runs
from benchmark.reference.jet import Jet, Line


class Workload(Runs):

    def __init__(self, config, mix, seed, device):
        self.line = mix['line']
        super().__init__(config, mix, seed, device, Line(self.line).nu0)

    def _call(self, epoch):
        self.jm.time = epoch
        return self.jm.rrl_rt_products(self.line, self.freqs,
                                       contsub=self.mix['contsub'],
                                       as_numpy=True)

    def reference(self, epochs, dtype):
        return Jet(self.params).rrl(self.line, epochs, self.freqs,
                                    self.mix['contsub'], dtype, self.device)
