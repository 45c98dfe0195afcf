"""A backlog that never empties, served ``batch`` requests at a time in
arrival order. The traced part is ``trace.batches`` whole batches."""

SERVES = "serve_batch"


def units(session):
    reqs, B = session.requests(), session.mix["batch"]
    while True:
        yield [next(reqs) for _ in range(B)]


def traced_enough(mix, traced) -> bool:
    return len(traced) >= mix["trace"].get("batches", 0)


def tally(run):
    B = run.mix["batch"]
    return B * len(run.records), B * len(run.failures)
