"""setup_s: seconds from the process's start to the window's first call
(imports, kernel libraries, inputs, tables, warm calls, graph captures)."""


def read(run):
    return run.setup_s
