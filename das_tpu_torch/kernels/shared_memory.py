"""The shared memory of every CUDA kernel under `csrc/`, declared.

Each `__global__` kernel is listed by "<source>:<kernel>" with the
`__shared__` buffers its body declares, in order ("name[dims]" for a
static buffer, "extern name[]" for the dynamic one), then the dynamic
shared-memory size of each launch that gives one ("dynamic: <expr>", the
third `<<<...>>>` argument as written).  The dynamic sizes are priced in
C by each kernel's plan function, named in the comments; the static
buffers are priced by their declarations.

Nothing reads this at run time.  The port's analyzer (daslint DL005)
holds it against the sources both ways: a buffer or a dynamic size
added to a kernel without its entry here, or an entry whose kernel
changed or went away, fails the lint — so every change to a kernel's
shared memory lands beside the plan function that prices it, under
review.  `budget.py` keeps pricing the TPU's VMEM for plan parity and is
not this file's concern."""

KERNEL_SHARED = {
    # anti_join.cu das_anti_join: a 2^bits-slot set of int64 keys in each
    # block (`das_set_bits(n_right)`, at most AJ_SHARED_MAX_BITS)
    "anti_join.cu:aj_shared_kernel": (
        "extern aj_set[]", "flag", "dynamic: sizeof(int64_t) << bits",
    ),
    "anti_join.cu:aj_init_kernel": (),
    "anti_join.cu:aj_build_kernel": (),
    "anti_join.cu:aj_probe_kernel": (),
    # group.cuh grp_plan: the filter set and the bin histogram
    # (p.smem = set_bytes + 4 * n_bins; 0 in the global regime)
    "group.cuh:grp_set_kernel": ("warp_tot[32]",),
    "group.cuh:grp_hist_kernel": ("extern grp_smem[]", "dynamic: (size_t)p.smem"),
    "group.cuh:grp_place_kernel": (
        "extern grp_smem[]", "wflag[64]", "wpre[GRP_GRID_WARPS+1]",
        "dynamic: kGlobal ? 0 : (size_t)(4 * n_bins)",
    ),
    "group.cuh:grp_run_kernel": (),
    # index_join.cu ij_plan: 32 B a left row (p.smem = 32 * n_left)
    "index_join.cu:ij_block_kernel": (
        "extern ij_smem[]", "warp_tot[32]", "dynamic: (size_t)p.smem",
    ),
    "index_join.cu:ij_bounds_kernel": (),
    "index_join.cu:ij_expand_kernel": (),
    # join_tables.cu jt_plan:
    # p.smem = 12 * 2^bits + 4 + 24 * n_right + 12 * n_left
    "join_tables.cu:jt_block_kernel": (
        "extern jt_smem[]", "warp_tot[32]", "wflag[64]", "dynamic: (size_t)p.smem",
    ),
    "join_tables.cu:jt_expand_kernel": (),
    # multiway.cu mw_plan:
    # p.smem = 8 * 2^bits + 20 * n_bins + 12 * n_rows + 20 * n_left
    "multiway.cu:mw_block_kernel": (
        "extern mw_smem[]", "warp_tot[32]", "totals[GRP_PARAM_TAILS]", "wflag[64]",
        "wcount[32]", "wpre[33]", "dynamic: (size_t)p.smem",
    ),
    "multiway.cu:mw_expand_kernel": (),
    "primitives.cu:scan_tile_kernel": ("warp_tot[DAS_THREADS/32]",),
    "primitives.cu:scan_add_kernel": (),
    "probe.cu:pr_terms_kernel": ("bounds[2]",),
}
