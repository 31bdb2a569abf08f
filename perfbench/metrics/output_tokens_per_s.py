"""Tokens that the window's completed requests asked for and received,
over the window (its start to its last completion)."""


def read(record):
    if not record["requests"]:
        return None
    return sum(r["tokens"] for r in record["requests"]) / record["window_s"]
