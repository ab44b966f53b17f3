"""End to end: seconds from the process's start to the end of the
driver's warm work: imports, the program's libraries, the model and
solver, one warm step at the cell's size."""


def read(rec):
    return rec["setup_s"]
