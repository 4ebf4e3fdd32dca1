"""Mean of ``QueryResult.autopsy()["queue_us"]`` (submit to dispatch) over
every answered request, in ms."""


def read(rec):
    q = rec.get("queue_us")
    if not q:
        return None
    return sum(q) / len(q) / 1e3
