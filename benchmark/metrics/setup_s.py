"""setup_s: process start to the first timed step (imports, kernel builds,
graph, the program's layouts, warm-up)."""


def read(record):
    return record.get("setup_s")
