"""host_syncs_per_iter: the program's counted device-to-host reads
(`HostSyncs.count`) per iteration (batched iteration) over the window."""


def read(run):
    return run.syncs / run.steps if run.steps else None
