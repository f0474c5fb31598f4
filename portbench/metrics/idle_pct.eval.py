"""Share of the traced pass in which no device operation ran."""


def read(record):
    tr = record.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100.0
