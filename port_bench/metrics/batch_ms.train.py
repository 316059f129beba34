"""Host milliseconds a train step spends in the trainer's batch source
(the sampler's next ids and ``_batch_from_pool``, its copy to the device
included), from the benchmark's own span around the call, over the
window's steps."""


def read(ctx):
    spans = ctx.get("batch_s")
    return sum(spans) / len(spans) * 1e3 if spans else None
