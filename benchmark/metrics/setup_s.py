"""setup_s: from the command's start to the window's start: manifests and
requests made, the server started (translate and compile of every
AuthConfig, the kernels' build on a checkout's first run, the warm
launch) and the generator's warm-up."""


def read(run):
    return run.setup_s
