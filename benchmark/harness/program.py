"""The system under test: one request is one ``run_sweep`` of the port,
called as ``python -m bdlz_tpu_torch.sweep_cli`` calls it, with the
keyword arguments the request carries (no output directory, no chunk
cache, no trace directory, one device)."""
from __future__ import annotations

from typing import Mapping

#: The outputs that the check compares.
OUTPUTS = ("Y_B", "Y_chi", "DM_over_B")


class Program:
    def __init__(self, config: Mapping, traffic: Mapping, device):
        from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config

        self.device = device
        self.base = config_from_dict(dict(config["yields_config"]))
        self.static = static_choices_from_config(self.base)._replace(**traffic.get("static", {}))

    def sweep(self, request):
        """The port's whole sweep of ``request``; returns its ``SweepResult``
        with host outputs."""
        from bdlz_tpu_torch.parallel.sweep import run_sweep

        return run_sweep(self.base, request.axes, self.static, device=self.device,
                         **request.kwargs)
