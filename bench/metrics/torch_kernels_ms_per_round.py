"""Device time a round of every operation that is not one of the port's
own kernels B1-B4: the clients' forward and backward under
``vmap(grad_and_value)``, the slab casts and stacks, the round's metric
reductions, copies and fills."""


def read(t):
    rest = t.device_s - t.port_kernels_s
    if not t.rounds or rest <= 0:
        return None
    return 1e3 * rest / t.rounds
