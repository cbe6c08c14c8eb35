"""gather.host_ms.closed: host ms a call of TorchIndex.search_batch_gather
(the wait for the batch's results, the guard's rescues and relaunches, the
unpacking)."""

from searchbench.readers import host_ms


def read(run):
    return host_ms(run, "TorchIndex.search_batch_gather")
