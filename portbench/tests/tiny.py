"""A cell made small enough for the CPU, and runs of it."""
from portbench import run

OVERRIDES = {
    "config": {"graph": {"num_vertices": 3000}, "receptive_field": 32,
               "n_layers": 3, "batch_size": 16,
               "store": {"nbr_capacity": 48, "subgraph_capacity": 48},
               "check": {"sample_targets": 16}},
    "traffic": {"fill": 32, "clients": 64},
}
# the open loop the knee sweep drives: Poisson arrivals filling about half
# of each batch at this size
OPEN = {"loop": "open", "rate_per_s": 3000}


def run_tiny(workload, seed=2**31 + 5, seconds=1.0, trace=False,
             loop="closed", **kw):
    """One run at the CPU's size, on the plain path (impl="torch"), in the
    cell's closed loop or in the open one."""
    ov = dict(OVERRIDES, traffic=dict(OVERRIDES["traffic"],
                                      **(OPEN if loop == "open" else {})))
    return run.run_cell(workload, seed, seconds, trace, device="cpu",
                        impl="torch", require_chip=False, overrides=ov,
                        **kw)
