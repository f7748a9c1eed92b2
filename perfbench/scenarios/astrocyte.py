"""The astrocyte tissue scenario through the program's entry point
``sim.build_astrocyte``: the configuration's ``scenario_args`` (the
keys of the scenario's YAML files), the traffic's pulsed ECS source and
synaptic stimulus, and the configuration's solver options."""

from knpemi_tpu_torch.sim.scenarios import build_astrocyte
from knpemi_tpu_torch.sim.stepper import SolverOptions

# the source keys of a traffic mix without an ECS source: never on
NO_SOURCE = dict(f_value=0.0, delay=0.0, period=1.0, pulse_width=0.0, end_time=-1.0)


def build(config: dict, traffic: dict, dtype, device):
    stim = traffic.get("stimulus", {})
    args = {**config["scenario_args"], **(stim.get("source") or NO_SOURCE),
            "g_syn_bar": float(stim.get("g_syn_bar", 0.0))}
    return build_astrocyte(args, dtype=dtype, device=device,
                           solver_options=SolverOptions(**config["solver"]))
