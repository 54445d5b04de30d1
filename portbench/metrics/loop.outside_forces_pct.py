"""Share of the window's wall time spent outside the synchronised force
timers (`Simulation.cpu_timers` gravity, hydro and pm): the main loop's
drift, kick, timestep and bookkeeping, and its host reads."""


def read(v):
    w = v["window"]
    t = w["timers"]
    forces = t.get("gravity", 0.0) + t.get("hydro", 0.0) + t.get("pm", 0.0)
    return 100.0 * (w["window_s"] - forces) / w["window_s"]
