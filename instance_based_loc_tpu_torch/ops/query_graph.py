"""CUDA-graph replay of the localise query program: the port's counterpart
of a jitted program's single dispatch.

One query runs ~6000 small kernels (bench scene, H100: PERF.md section 5),
so an eager query is bound by the host's launches. `QueryGraph` captures
`localise_frames_batched` once per shape bucket (the query tensors' shapes
and types, the memory, the scalars and the statics, G queries) and replays
it: a replay launches the whole program at once.

Replay draws what the eager program draws. Each query's generator is
registered with the graph and re-seeded to that query's seed before every
replay (the seed `ObjectMemory` gives the frame), so a philox stream starts
where a freshly seeded eager generator starts and advances by the same
offsets.

Two configurations cannot be captured, and run eager; `graphable` decides
from the statics alone:
  * radius-outlier passes (`outlier_passes` > 0): `radius_neighbor_counts`
    compacts the masked points with `torch.nonzero`, a host sync with a
    data-dependent shape;
  * ICP's early exit: it reads on the host whether any lane still runs.
bench.py's serving configuration (`outlier_removal_config=None`,
`IBL_ICP_EARLY_EXIT=0`) has neither.

A capture or replay that fails raises; nothing falls back to eager.
"""

from __future__ import annotations

import torch

from .localise_kernels import localise_frames_batched

# the query-side inputs of localise_frames_batched, in argument order
QUERY_TENSORS = ("depth", "rgb", "masks", "det_embs", "det_valid")


def graphable(statics: dict) -> bool:
    """Whether the query program of these statics can be captured."""
    return statics["outlier_passes"] == 0 and not statics["icp_early_exit"]


class QueryGraph:
    """`localise_frames_batched` captured for one bucket.

    query: the first chunk's query tensors on the card ({name: (G, ...)});
    mem_args, scalars, statics: the rest of the program's arguments, fixed
    for the graph's life (the memory tensors are read in place)."""

    def __init__(self, query: dict, mem_args: tuple, scalars: tuple,
                 statics: dict):
        if not graphable(statics):
            raise ValueError("this query configuration syncs with the host "
                             "(radius-outlier passes or ICP early exit) and "
                             "cannot be captured")
        dev = query["depth"].device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, got {dev}")
        g_n = query["depth"].shape[0]
        self.inputs = {name: query[name].clone() for name in QUERY_TENSORS}
        self.generators = [torch.Generator(device=dev) for _ in range(g_n)]

        def program():
            return localise_frames_batched(
                *(self.inputs[name] for name in QUERY_TENSORS), *mem_args,
                *scalars, self.generators, **statics)

        # one eager run on a side stream first: lazy initialisation (library
        # handles, the device constants the program caches) stays out of the
        # capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            program()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            self.graph.register_generator_state(gen)
        # thread_local: a consumer thread fetching an earlier chunk's results
        # may call the runtime while this thread captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = program()

    def run(self, query: dict, seeds) -> dict:
        """Copy the chunk's query tensors in, seed each query's generator,
        replay. Returns the graph's output tensors, which the next replay
        overwrites: copy what is needed before then (stream order keeps a
        copy enqueued now ahead of it)."""
        if len(seeds) != len(self.generators):
            raise ValueError(f"{len(seeds)} seeds for a graph of "
                             f"{len(self.generators)} queries")
        for name in QUERY_TENSORS:
            self.inputs[name].copy_(query[name], non_blocking=True)
        for gen, seed in zip(self.generators, seeds):
            gen.manual_seed(int(seed))
        self.graph.replay()
        return self.outputs
