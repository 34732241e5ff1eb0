"""mfu.serve (%): the model's operations a request (the `FlopCounterMode`
count of convolutions and matmuls plus the kNN's and the correlation's
counts from their call shapes, taken on one request after the window) times
the window's requests, over their seconds and over the card's dense bf16
peak."""


def read(t):
    if not t.peaks or not t.plain_request_s or not t.flops_per_request:
        return None
    rate = t.flops_per_request * len(t.plain_request_s) / sum(t.plain_request_s)
    return 100.0 * rate / t.peaks["bf16_flops"]
