"""The SIR time loop's share of its roofline over the window's eager sets,
in percent: the least time the card could take for each set's loop,
counted from the program's own count of the steps a row ran
(``timings[*]["sim_steps"]``) over the set's rows
(``kernels/sir_loop.py``), over the summed ``simulate_ms`` of those sets
(the program's CUDA events around the simulate stage). Nothing is read
from a program without the counter, or where no eager set was timed."""

from port_bench import registry

UNIT, BETTER, SOURCE = "%", "higher", "program_span"
LAYER, MOVES = "simulator", "particles_per_s"


def read(record):
    k = registry.kernel("sir_loop")
    sizes = record["traffic"].sizes
    least = spent = 0.0
    for f in record["fits"]:
        for s in f["sets"]:
            if s.get("simulate_ms") is None or s.get("sim_steps") is None:
                continue
            least += k.least_ms(s["sim_steps"], sizes[s["set"]])
            spent += s["simulate_ms"]
    return 100.0 * least / spent if spent > 0 else None
