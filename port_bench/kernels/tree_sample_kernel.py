"""K2, the stratified descent of the PER sum tree (``csrc/tree_sample.cu``):
per launch D = U·B target masses. Bytes: the masses read once, each
index (int64) and priority written once, and at each level the child rows
the draws need, at most one row of the node's children per draw and no
more rows than the level has nodes (stratified draws fall in distinct
nodes until the strata outnumber them). FLOPs: the additions of each
node's children."""


def work(ctx):
    t = ctx.traffic
    D = t["updates_per_iter"] * t["batch_size"]
    sizes = ctx.work.tree_levels(t["buffer_size"])
    nbytes = 4 * D + 12 * D
    flops = 0
    for child, parent in zip(sizes[:-1], sizes[1:]):
        bf = child // parent
        nbytes += 4 * bf * min(D, parent)
        flops += D * bf
    return flops, nbytes
