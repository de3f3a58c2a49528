"""From the process's first line to the window's start: imports, the
pool's lowering, upload, kernel builds, comb tables, capture and warm-up."""


def read(record: dict):
    return record["setup_s"]
