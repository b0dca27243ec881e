"""Process start to the start of the measured window: imports, the
system's libraries and kernels (built or loaded), the warm-up job, the
measured job's start and its lead-in."""


def read(record):
    return record["setup_s"]
