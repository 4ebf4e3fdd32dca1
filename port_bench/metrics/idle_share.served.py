"""100 - the mean of nvidia-smi's utilization.gpu (every process on the
card: the replicas launch the kernels) sampled every 100 ms over the window."""


def read(rec):
    util = [u for _, u, _ in rec.get("smi", ())]
    if not util:
        return None
    return 100.0 - sum(util) / len(util)
