"""The call graph and the CUDA reader under das_tpu_torch's analyzer
(das_tpu_torch/analysis/callgraph.py, analysis/cuda.py).

Pins the resolution the DL010 / DL011 / DL012 rules lean on: module
naming under das_tpu_torch, bare and imported calls, `self.method`
through base classes, nested defs folding into their owner, cycles,
the local aliases the port's dispatch halves use (`run = run_conj`;
`dispatch = a.f if sharded else a.g`), the walk's stop predicate, and
on the real tree the dispatch roots reaching their programs; then the
CUDA reader: comments stripped with lines kept, kernel names past
attribute macros, shared declarations, launch configurations with shifts
and templates, and the extern "C" entries."""

from pathlib import Path

from das_tpu_torch.analysis.callgraph import (
    CallGraph,
    callgraph,
    module_dotted,
    module_table,
    scope_module,
)
from das_tpu_torch.analysis.core import AnalysisContext, CudaFile, collect_files
from das_tpu_torch.analysis.cuda import model, strip_comments

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "das_tpu_torch"


def _graph(tmp_path, sources):
    files = []
    for name, src in sources.items():
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
        files.append(p)
    sfs = collect_files(files)
    return CallGraph(sfs), {sf.name: sf for sf in sfs}


def _reached(graph, sf, node, cls=None, stop=None):
    return {info.qname: path for info, path in graph.walk(sf, node, cls, stop=stop)}


def test_module_naming():
    sfs = collect_files([PORT / "query/fused.py", PORT / "planner/__init__.py"])
    assert module_dotted(sfs[0]) == "das_tpu_torch.query.fused"
    assert module_dotted(sfs[1]) == "das_tpu_torch.planner"
    assert scope_module(sfs[0]) == "fused"
    assert scope_module(sfs[1]) == "planner"


def test_cycles_terminate_and_paths_are_shortest(tmp_path):
    graph, sfs = _graph(tmp_path, {"loop.py": (
        "def a():\n    b()\n"
        "def b():\n    a()\n    c()\n"
        "def c():\n    pass\n"
    )})
    sf = sfs["loop"]
    reached = _reached(graph, sf, module_table(sf).defs["a"])
    assert set(reached) == {"loop::a", "loop::b", "loop::c"}
    assert [q for _l, q in reached["loop::c"]] == ["loop::b", "loop::c"]


def test_method_resolution_through_base_and_nested_defs(tmp_path):
    graph, sfs = _graph(tmp_path, {"jobs.py": (
        "class Base:\n"
        "    def helper(self):\n        leaf()\n"
        "class Job(Base):\n"
        "    def dispatch(self):\n"
        "        def inner():\n            self.helper()\n"
        "        inner()\n"
        "def leaf():\n    pass\n"
    )})
    sf = sfs["jobs"]
    reached = _reached(graph, sf, module_table(sf).methods["Job"]["dispatch"], "Job")
    assert {"jobs::Base.helper", "jobs::leaf"} <= set(reached)


def test_local_aliases_resolve(tmp_path):
    graph, sfs = _graph(tmp_path, {
        "progs.py": "def run_conj():\n    pass\ndef run_exact():\n    pass\n",
        "user.py": (
            "import progs\n"
            "from progs import run_conj\n"
            "def go(flag):\n"
            "    run = run_conj\n"
            "    pick = progs.run_exact if flag else run_conj\n"
            "    run()\n"
            "    pick()\n"
            "def opaque(cb):\n    cb()\n"
        ),
    })
    sf = sfs["user"]
    t = module_table(sf)
    assert set(_reached(graph, sf, t.defs["go"])) == {"progs::run_conj", "progs::run_exact"}
    assert _reached(graph, sf, t.defs["opaque"]) == {}


def test_walk_stop_prunes_what_only_it_reaches(tmp_path):
    graph, sfs = _graph(tmp_path, {"s.py": (
        "def root():\n    wrapper()\n    other()\n"
        "def wrapper():\n    inner()\n"
        "def inner():\n    pass\n"
        "def other():\n    pass\n"
    )})
    sf = sfs["s"]
    reached = _reached(graph, sf, module_table(sf).defs["root"],
                       stop=lambda info: info.qname == "s::wrapper")
    assert set(reached) == {"s::other"}


def test_context_caches_one_graph():
    ctx = AnalysisContext(collect_files([PORT / "analysis/callgraph.py"]), None)
    assert callgraph(ctx) is callgraph(ctx)


def test_real_tree_dispatch_roots_reach_their_programs():
    """_ExecJob.dispatch reaches run_conj through `run = run_conj`, the
    tree job its builder, and the facade's batched job the executor's
    dispatch through the conditional alias."""
    files = collect_files([PORT])
    graph = CallGraph(files)
    by = {sf.posix.split("das_tpu_torch/", 1)[1]: sf for sf in files}
    fused = by["query/fused.py"]
    t = module_table(fused)
    reached = set(_reached(graph, fused, t.methods["_ExecJob"]["dispatch"], "_ExecJob"))
    assert "das_tpu_torch.query.fused::run_conj" in reached
    reached = set(_reached(graph, fused, t.methods["_TreeExecJob"]["dispatch"],
                           "_TreeExecJob"))
    assert "das_tpu_torch.query.fused::build_fused_tree" in reached
    api = by["api/atomspace.py"]
    reached = set(_reached(graph, api, module_table(api).methods["_QueryManyJob"]["__init__"],
                           "_QueryManyJob"))
    assert {"das_tpu_torch.query.compiler::execute_fused_many_dispatch",
            "das_tpu_torch.query.compiler::execute_sharded_many_dispatch"} <= reached


# -- the CUDA reader -----------------------------------------------------------


def _cuda(tmp_path, text):
    p = tmp_path / "k.cu"
    p.write_text(text)
    return model(CudaFile(p, text))


def test_comments_and_strings_are_blanked_in_place():
    text = 'a // __shared__ x;\n/* __global__\n */ b "__global__" extern "C" c\n'
    out = strip_comments(text)
    assert len(out) == len(text) and out.count("\n") == text.count("\n")
    assert "__shared__" not in out and "__global__" not in out
    assert 'extern "C" c' in out


def test_kernels_shared_launches_and_entries(tmp_path):
    m = _cuda(tmp_path, '''
template <bool kGlobal, typename Keys>
__global__ void __launch_bounds__(256, 2) hist_kernel(Keys k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t wpre[WARPS + 1];
}
__global__ void plain_kernel(const __grid_constant__ Args a);  // a declaration
__global__ void plain_kernel(const __grid_constant__ Args a) { }
extern "C" int64_t das_x_scratch(int64_t n) { return n; }
extern "C" int das_x(void* st) {
  hist_kernel<kGlobal, Keys><<<(unsigned)G, 256, kGlobal ? 0 : (size_t)(4 * n_bins), st>>>(k);
  plain_kernel<<<blocks(n), 128, sizeof(int64_t) << bits, st>>>(a);
  plain_kernel<<<1, 32>>>(a);
  return 0;
}
''')
    assert [(k.name, [d for _l, d in k.shared]) for k in m.kernels] == [
        ("hist_kernel", ["extern smem[]", "wpre[WARPS+1]"]), ("plain_kernel", [])]
    assert m.kernels[0].line == 3
    assert [(la.kernel, la.dynamic_smem) for la in m.launches] == [
        ("hist_kernel", "kGlobal ? 0 : (size_t)(4 * n_bins)"),
        ("plain_kernel", "sizeof(int64_t) << bits"),
        ("plain_kernel", None)]
    assert [name for _l, name in m.entries] == ["das_x_scratch", "das_x"]
    assert not m.stray_shared


def test_real_sources_read_whole():
    """Every extern "C" entry of csrc/ is one launch.py binds, and every
    kernel the sources define has a body."""
    from das_tpu_torch.kernels import launch
    from das_tpu_torch.kernels.shared_memory import KERNEL_SHARED

    entries, kernels = set(), []
    for p in sorted((PORT / "kernels/csrc").iterdir()):
        m = model(CudaFile(p, p.read_text()))
        entries |= {name for _l, name in m.entries}
        kernels += m.kernels
    assert entries == set(launch._SIGNATURES)
    assert len(kernels) == len(KERNEL_SHARED)
    assert all(k.body[1] > k.body[0] for k in kernels)
