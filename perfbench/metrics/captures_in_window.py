"""CUDA graphs the capture cache captured inside the window: the delta of
the program's ``cuda_graph_captures_total`` over it."""


def read(run):
    return None if run.captures is None else float(run.captures)
