"""plan.host_ms.closed: mean host ms of a batch's plan in
TorchIndex: shortcuts, plan_full or plan_sparse, chunk budgets, plan
packing (the program's span index.plan, over the traced stretch)."""

from searchbench.spans import mean_ms


def read(run):
    return mean_ms(run, "index.plan")
