"""setup_s: seconds from the process's start to the window's opening:
weights, engine, kernel loads and builds, graph captures, the warm-up."""


def read(run):
    return run["setup_s"]
