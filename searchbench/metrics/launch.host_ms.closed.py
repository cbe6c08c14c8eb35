"""launch.host_ms.closed: host ms a call of TorchIndex.search_batch_async
(the planner, plan upload and the launch or its graph's replay)."""

from searchbench.readers import host_ms


def read(run):
    return host_ms(run, "TorchIndex.search_batch_async")
