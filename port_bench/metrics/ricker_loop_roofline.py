"""The Ricker map's time loop's share of its roofline over the window's
eager sets, in percent: the least time the card could take for each set's
loop (``kernels/ricker_loop.py``), counted from the program's own counts a
row of the steps its loop ran (``timings[*]["sim_steps"]``) and of the
observed steps whose Poisson draw took the 24-point grid
(``timings[*]["sim_grid_steps"]``), the configuration's observed steps a
row (``reference.t_steps``) and the set's rows, over the summed
``simulate_ms`` of those sets (the program's CUDA events around the
simulate stage). Nothing is read from a program without the grid counter,
or where no eager set was timed."""

from port_bench import registry

UNIT, BETTER, SOURCE = "%", "higher", "program_span"
LAYER, MOVES = "simulator", "particles_per_s"


def read(record):
    k = registry.kernel("ricker_loop")
    sizes = record["traffic"].sizes
    observed = float(record["config"]["reference"]["t_steps"])
    least = spent = 0.0
    for f in record["fits"]:
        for s in f["sets"]:
            if None in (s.get("simulate_ms"), s.get("sim_steps"),
                        s.get("sim_grid_steps")):
                continue
            least += k.least_ms(s["sim_steps"], observed,
                                s["sim_grid_steps"], sizes[s["set"]])
            spent += s["simulate_ms"]
    return 100.0 * least / spent if spent > 0 else None
