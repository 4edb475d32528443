"""CUDA runtime and driver calls that launch work on the card
(``cudaLaunchKernel`` and its kin, graph launches), a round."""


def read(t):
    if not t.rounds or not t.launch_calls:
        return None
    return t.launch_calls / t.rounds
