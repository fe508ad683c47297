"""Set-up: from the process's start to the first timed call (data, the
build, the re-attach, the warm-up cycles; in a checkout's first run also
the kernel library's build)."""

UNIT = "s"


def read(run):
    return run.setup_s
