"""setup_s: seconds from the process's start to the window's start (import,
CUDA context, kernel load or build, bind, operands, warm-up). Host clock."""


def read(rec: dict) -> float:
    return rec["setup_s"]
