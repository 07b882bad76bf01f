"""``continuum_runs``: a closed loop of continuum RT runs, one client; a
request sets the model's epoch and asks
``JetModel.continuum_rt_products(freqs, as_numpy=True)`` over the mix's
``freqs_hz``.  Keys: ``freqs_hz``, ``epochs_yr``, ``sample_runs``,
``trace_requests``."""
from benchmark.harness.workloads import Runs
from benchmark.reference.jet import Jet


class Workload(Runs):

    def _call(self, epoch):
        self.jm.time = epoch
        return self.jm.continuum_rt_products(self.freqs, as_numpy=True)

    def reference(self, epochs, dtype):
        return Jet(self.params).continuum(epochs, self.freqs, dtype,
                                          self.device)
