"""Mean requests per device batch over the run's batches (the server's
``batch_log``): how full the dynamic batcher keeps the sampler."""


def read(record):
    log = record.get("batch_log") if record.get("kind") == "serve" else None
    if not log:
        return None
    return sum(n for (_, _, n, _) in log) / len(log)
