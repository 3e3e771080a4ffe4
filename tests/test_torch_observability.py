"""The port's observability utilities on the CPU: the dashboard and
``sonet-torch monitor`` over the port's own metric files
(``utils.logging.MetricLogger``), ``diagnose_grads`` against
``sonet_tpu``'s, ``hlocat.categorize`` on kernel names as an H100 trace
prints them, ``tprof.device_time``, ``trace``, ``scan_bench`` and
``enable_nan_checks`` on CPU functions (their card cases are in
``tests/test_torch_cuda.py``).

Tolerances: ``diagnose_grads`` within 1e-6 relative of ``sonet_tpu``'s
on the same gradients (float32 sums there, float64 here).
"""

import json
import os
import sys
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonet_tpu.utils import profiling as jprof
from sonet_torch import cli as tcli
from sonet_torch import config as tcfg
from sonet_torch.convert import gradients_to_jax
from sonet_torch.models import build_model
from sonet_torch.utils import hlocat, profiling, tprof
from sonet_torch.utils.dashboard import (list_runs, make_dashboard_server,
                                         read_metrics)
from sonet_torch.utils.logging import MetricLogger

torch.set_num_threads(2)

# (bucket, kernel name), as torch.profiler named them on
# "NVIDIA H100 80GB HBM3" (700.00 W) for the modelnet40() forward and
# train step (chip_smoke.py phase 24, profile_tprof_*.txt)
H100_KERNELS = [
    ('pooling kernel',
     'void (anonymous namespace)::segment_max_window_bulk<__nv_bfloat16>'
     '(unsigned int const*, int const*, float*, int, int, int, int, int,'
     ' int, int)'),
    ('pooling kernel',
     '(anonymous namespace)::fill_empty(float*, long)'),
    ('GEMMs',
     'sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warps'
     'ize1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas'),
    ('GEMMs',
     'nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN'),
    ('sorts',
     'void at::native::radixSortKVInPlace<2, -1, 32, 4, float, long, uns'
     'igned int>(at::cuda::detail::TensorInfo<float, unsigned int>, unsi'
     'gned int, unsigned int, unsigned int, at::cuda::detail::TensorInfo'
     '<long, unsigned int>, unsigned int, bool)'),
    ('sorts',
     'void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_de'
     'tail::cub::DeviceRadixSortPolicy<int, at::cuda::cub::detail::Opaqu'
     'eType<8>, unsigned long long>::Policy900, false, int, at::cuda::cu'
     'b::detail::OpaqueType<8>, unsigned long long, int, int, at_cuda_de'
     'tail::cub::detail::identity_decomposer_t>(int*, int*, unsigned lon'
     'g long*, unsigned long long const*, int*, int const*, at::cuda::cu'
     'b::detail::OpaqueType<8>*, at::cuda::cub::detail::OpaqueType<8> co'
     'nst*, int, int, int, at_cuda_detail::cub::detail::identity_decompo'
     'ser_t)'),
    ('sorts',
     'void at::native::(anonymous namespace)::sort_postprocess_kernel<in'
     't>(int const*, int*, long*, int2 const*, int, int)'),
    ('sorts',
     'at::native::(anonymous namespace)::fill_index_and_segment_kernel(i'
     'nt2*, int, at::cuda::detail::IntDivider<unsigned int>)'),
    ('other',
     'void at::native::(anonymous namespace)::searchsorted_cuda_kernel<i'
     'nt, long>(long*, int const*, int const*, long const*, long, long, '
     'long, bool, bool)'),
    ('copies and memsets',
     'Memcpy DtoD (Device -> Device)'),
    ('copies and memsets',
     'Memset (Device)'),
    ('copies and memsets',
     'void at::native::(anonymous namespace)::CatArrayBatchedCopy_aligne'
     'dK_contig<at::native::(anonymous namespace)::OpaqueType<4u>, unsig'
     'ned int, 3, 128, 1, 16>(at::native::(anonymous namespace)::OpaqueT'
     'ype<4u>*, at::native::(anonymous namespace)::CatArrInputTensorMeta'
     'data<at::native::(anonymous namespace)::OpaqueType<4u>, unsigned i'
     'nt, 128, 1>, at::native::(anonymous namespace)::TensorSizeStride<u'
     'nsigned int, 4u>, int, unsigned int)'),
    ('copies and memsets',
     'void at::native::unrolled_elementwise_kernel<at::native::direct_co'
     'py_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()('
     ') const::{lambda()#12}::operator()() const::{lambda(c10::BFloat16)'
     '#1}, std::array<char*, 2ul>, 4, TrivialOffsetCalculator<1, unsigne'
     'd int>, TrivialOffsetCalculator<1, unsigned int>, at::native::memo'
     'ry::LoadWithCast<1>, at::native::memory::StoreWithCast<1> >(int, a'
     't::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lamb'
     'da()#3}::operator()() const::{lambda()#12}::operator()() const::{l'
     'ambda(c10::BFloat16)#1}, std::array<char*, 2ul>, TrivialOffsetCalc'
     'ulator<1, unsigned int>, TrivialOffsetCalculator<1, unsigned int>,'
     ' at::native::memory::LoadWithCast<1>, at::native::memory::StoreWit'
     'hCast<1>)'),
    ('Adam',
     'void at::native::(anonymous namespace)::multi_tensor_apply_kernel<'
     'at::native::(anonymous namespace)::TensorListMetadata<2>, at::nati'
     've::(anonymous namespace)::TernaryOpScalarFunctor<float, 2, 2, 0>,'
     ' at::native::LerpFunctor<float>, float>(at::native::(anonymous nam'
     'espace)::TensorListMetadata<2>, at::native::(anonymous namespace):'
     ':TernaryOpScalarFunctor<float, 2, 2, 0>, at::native::LerpFunctor<f'
     'loat>, float)'),
    ('Adam',
     'void at::native::(anonymous namespace)::multi_tensor_apply_kernel<'
     'at::native::(anonymous namespace)::TensorListMetadata<2>, at::nati'
     've::(anonymous namespace)::UnaryOpFunctor<float, 2, 1, 1>, at::nat'
     'ive::Sqrt<float> >(at::native::(anonymous namespace)::TensorListMe'
     'tadata<2>, at::native::(anonymous namespace)::UnaryOpFunctor<float'
     ', 2, 1, 1>, at::native::Sqrt<float>)'),
    ('BatchNorm statistics and other reductions',
     'void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float,'
     ' at::native::MeanOps<float, float, float, float>, unsigned int, fl'
     'oat, 4, 4> >(at::native::ReduceOp<float, at::native::MeanOps<float'
     ', float, float, float>, unsigned int, float, 4, 4>)'),
    ('BatchNorm statistics and other reductions',
     'void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float,'
     ' at::native::ArgMaxOps<float>, unsigned int, long, 4, 4> >(at::nat'
     'ive::ReduceOp<float, at::native::ArgMaxOps<float>, unsigned int, l'
     'ong, 4, 4>)'),
    ('BatchNorm statistics and other reductions',
     'void at::native::(anonymous namespace)::nll_loss_forward_reduce_cu'
     'da_kernel_2d<float, float, long>(float*, float*, float const*, lon'
     'g const*, float const*, bool, long, long, long, long)'),
    ('other',
     'void at::native::_scatter_gather_elementwise_kernel<128, 8, at::na'
     'tive::_cuda_scatter_gather_internal_kernel<true, float, long>::ope'
     'rator()<at::native::ReduceAdd>(at::TensorIterator&, long, long, lo'
     'ng, at::native::ReduceAdd const&)::{lambda(int)#1}>(int, at::nativ'
     'e::_cuda_scatter_gather_internal_kernel<true, float, long>::operat'
     'or()<at::native::ReduceAdd>(at::TensorIterator&, long, long, long,'
     ' at::native::ReduceAdd const&)::{lambda(int)#1})'),
    ('other',
     'void at::native::index_elementwise_kernel<128, 4, at::native::gpu_'
     'index_kernel<at::native::index_put_kernel_impl<at::native::OpaqueT'
     'ype<2> >(at::TensorIterator&, c10::ArrayRef<long>, c10::ArrayRef<l'
     'ong>)::{lambda(char*, char const*, long)#1}>(at::TensorIteratorBas'
     'e&, c10::ArrayRef<long>, c10::ArrayRef<long>, at::native::index_pu'
     't_kernel_impl<at::native::OpaqueType<2> >(at::TensorIterator&, c10'
     '::ArrayRef<long>, c10::ArrayRef<long>)::{lambda(char*, char const*'
     ', long)#1} const&, bool)::{lambda(int)#1}>(long, at::native::gpu_i'
     'ndex_kernel<at::native::index_put_kernel_impl<at::native::OpaqueTy'
     'pe<2> >(at::TensorIterator&, c10::ArrayRef<long>, c10::ArrayRef<lo'
     'ng>)::{lambda(char*, char const*, long)#1}>(at::TensorIteratorBase'
     '&, c10::ArrayRef<long>, c10::ArrayRef<long>, at::native::index_put'
     '_kernel_impl<at::native::OpaqueType<2> >(at::TensorIterator&, c10:'
     ':ArrayRef<long>, c10::ArrayRef<long>)::{lambda(char*, char const*,'
     ' long)#1} const&, bool)::{lambda(int)#1})'),
    ('other',
     'void (anonymous namespace)::indexing_backward_kernel<c10::BFloat16'
     ', 4>(long const*, long const*, c10::BFloat16 const*, c10::BFloat16'
     '*, long, long, long, long, bool)'),
    ('other',
     'void (anonymous namespace)::softmax_warp_forward<float, float, flo'
     'at, 6, true, false>(float*, float const*, int, int, int, bool cons'
     't*, int, bool)'),
    ('elementwise',
     'void at::native::vectorized_elementwise_kernel<8, at::native::bflo'
     'at16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1},'
     ' std::array<char*, 2ul> >(int, at::native::bfloat16_copy_kernel_cu'
     'da(at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, '
     '2ul>)'),
    ('elementwise',
     'void at::native::vectorized_elementwise_kernel<4, at::native::CUDA'
     'Functor_add<float>, std::array<char*, 3ul> >(int, at::native::CUDA'
     'Functor_add<float>, std::array<char*, 3ul>)'),
    ('elementwise',
     'void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel'
     '_impl_nocast<at::native::(anonymous namespace)::where_kernel_impl('
     'at::TensorIterator&)::{lambda()#1}::operator()() const::{lambda()#'
     '11}::operator()() const::{lambda(bool, float, float)#1}>(at::Tenso'
     'rIteratorBase&, at::native::(anonymous namespace)::where_kernel_im'
     'pl(at::TensorIterator&)::{lambda()#1}::operator()() const::{lambda'
     '()#11}::operator()() const::{lambda(bool, float, float)#1} const&)'
     '::{lambda(int)#1}>(int, at::native::gpu_kernel_impl_nocast<at::nat'
     'ive::(anonymous namespace)::where_kernel_impl(at::TensorIterator&)'
     '::{lambda()#1}::operator()() const::{lambda()#11}::operator()() co'
     'nst::{lambda(bool, float, float)#1}>(at::TensorIteratorBase&, at::'
     'native::(anonymous namespace)::where_kernel_impl(at::TensorIterato'
     'r&)::{lambda()#1}::operator()() const::{lambda()#11}::operator()()'
     ' const::{lambda(bool, float, float)#1} const&)::{lambda(int)#1})'),
    ('elementwise',
     'void at::native::(anonymous namespace)::distribution_elementwise_g'
     'rid_stride_kernel<float, 4, at::native::templates::cuda::uniform_a'
     'nd_transform<float, float, at::CUDAGeneratorImpl*, at::native::tem'
     'plates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIte'
     'ratorBase&, double, double, at::CUDAGeneratorImpl*)::{lambda()#1}:'
     ':operator()() const::{lambda()#2}::operator()() const::{lambda(flo'
     'at)#1}>(at::TensorIteratorBase&, at::CUDAGeneratorImpl*, at::nativ'
     'e::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::Ten'
     'sorIteratorBase&, double, double, at::CUDAGeneratorImpl*)::{lambda'
     '()#1}::operator()() const::{lambda()#2}::operator()() const::{lamb'
     'da(float)#1})::{lambda(curandStatePhilox4_32_10*)#2}, at::native::'
     '(anonymous namespace)::distribution_nullary_kernel<float, float, f'
     'loat4, at::CUDAGeneratorImpl*, at::native::templates::cuda::unifor'
     'm_and_transform<float, float, at::CUDAGeneratorImpl*, at::native::'
     'templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::Tensor'
     'IteratorBase&, double, double, at::CUDAGeneratorImpl*)::{lambda()#'
     '1}::operator()() const::{lambda()#2}::operator()() const::{lambda('
     'float)#1}>(at::TensorIteratorBase&, at::CUDAGeneratorImpl*, at::na'
     'tive::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::'
     'TensorIteratorBase&, double, double, at::CUDAGeneratorImpl*)::{lam'
     'bda()#1}::operator()() const::{lambda()#2}::operator()() const::{l'
     'ambda(float)#1})::{lambda(curandStatePhilox4_32_10*)#2}, at::nativ'
     'e::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::Ten'
     'sorIteratorBase&, double, double, at::CUDAGeneratorImpl*)::{lambda'
     '()#1}::operator()() const::{lambda()#2}::operator()() const::{lamb'
     'da(float)#1}>(at::TensorIteratorBase&, at::CUDAGeneratorImpl*, at:'
     ':native::templates::cuda::uniform_and_transform<float, float, at::'
     'CUDAGeneratorImpl*, at::native::templates::cuda::uniform_kernel<at'
     '::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, double, at:'
     ':CUDAGeneratorImpl*)::{lambda()#1}::operator()() const::{lambda()#'
     '2}::operator()() const::{lambda(float)#1}>(at::TensorIteratorBase&'
     ', at::CUDAGeneratorImpl*, at::native::templates::cuda::uniform_ker'
     'nel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, doubl'
     'e, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() const::{lam'
     'bda()#2}::operator()() const::{lambda(float)#1})::{lambda(curandSt'
     'atePhilox4_32_10*)#2} const&, at::native::templates::cuda::uniform'
     '_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, d'
     'ouble, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() const::'
     '{lambda()#2}::operator()() const::{lambda(float)#1})::{lambda(int,'
     ' float)#1}>(long, at::PhiloxCudaState, at::native::templates::cuda'
     '::uniform_and_transform<float, float, at::CUDAGeneratorImpl*, at::'
     'native::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at'
     '::TensorIteratorBase&, double, double, at::CUDAGeneratorImpl*)::{l'
     'ambda()#1}::operator()() const::{lambda()#2}::operator()() const::'
     '{lambda(float)#1}>(at::TensorIteratorBase&, at::CUDAGeneratorImpl*'
     ', at::native::templates::cuda::uniform_kernel<at::CUDAGeneratorImp'
     'l*>(at::TensorIteratorBase&, double, double, at::CUDAGeneratorImpl'
     '*)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() c'
     'onst::{lambda(float)#1})::{lambda(curandStatePhilox4_32_10*)#2}, a'
     't::native::(anonymous namespace)::distribution_nullary_kernel<floa'
     't, float, float4, at::CUDAGeneratorImpl*, at::native::templates::c'
     'uda::uniform_and_transform<float, float, at::CUDAGeneratorImpl*, a'
     't::native::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>'
     '(at::TensorIteratorBase&, double, double, at::CUDAGeneratorImpl*):'
     ':{lambda()#1}::operator()() const::{lambda()#2}::operator()() cons'
     't::{lambda(float)#1}>(at::TensorIteratorBase&, at::CUDAGeneratorIm'
     'pl*, at::native::templates::cuda::uniform_kernel<at::CUDAGenerator'
     'Impl*>(at::TensorIteratorBase&, double, double, at::CUDAGeneratorI'
     'mpl*)::{lambda()#1}::operator()() const::{lambda()#2}::operator()('
     ') const::{lambda(float)#1})::{lambda(curandStatePhilox4_32_10*)#2}'
     ', at::native::templates::cuda::uniform_kernel<at::CUDAGeneratorImp'
     'l*>(at::TensorIteratorBase&, double, double, at::CUDAGeneratorImpl'
     '*)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() c'
     'onst::{lambda(float)#1}>(at::TensorIteratorBase&, at::CUDAGenerato'
     'rImpl*, at::native::templates::cuda::uniform_and_transform<float, '
     'float, at::CUDAGeneratorImpl*, at::native::templates::cuda::unifor'
     'm_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, '
     'double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() const:'
     ':{lambda()#2}::operator()() const::{lambda(float)#1}>(at::TensorIt'
     'eratorBase&, at::CUDAGeneratorImpl*, at::native::templates::cuda::'
     'uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, do'
     'uble, double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() '
     'const::{lambda()#2}::operator()() const::{lambda(float)#1})::{lamb'
     'da(curandStatePhilox4_32_10*)#2} const&, at::native::templates::cu'
     'da::uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&'
     ', double, double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator('
     ')() const::{lambda()#2}::operator()() const::{lambda(float)#1})::{'
     'lambda(int, float)#1})'),
]


def _log_rows(run_dir, rows, prefix="train_"):
    """Rows as the port's Trainer writes them (``MetricLogger``)."""
    logger = MetricLogger(run_dir, quiet=True)
    for step, metrics in rows:
        logger.log(step, metrics, epoch=0, prefix=prefix)
    logger.jsonl.close()


def _get(srv, path):
    port = srv.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# ---------------------------------------------------------------------------
# the dashboard and the monitor command
# ---------------------------------------------------------------------------

def test_read_metrics_follows_the_loggers_file(tmp_path):
    run = str(tmp_path / "r")
    _log_rows(run, [(1, {"loss": 2.0})])
    rows, cur = read_metrics(run)
    assert [(r["step"], r["train_loss"], r["epoch"]) for r in rows] == [
        (1, 2.0, 0)]
    assert read_metrics(run, since=cur) == ([], cur)
    _log_rows(run, [(2, {"loss": 1.0}), (3, {"loss": 0.5})])
    rows, cur2 = read_metrics(run, since=cur)
    assert [r["step"] for r in rows] == [2, 3] and cur2 > cur


def test_a_partial_trailing_line_is_read_when_whole(tmp_path):
    run = str(tmp_path / "r")
    _log_rows(run, [(1, {"loss": 2.0})])
    path = os.path.join(run, "train_metrics.jsonl")
    with open(path, "a") as f:
        f.write('{"step": 2, "train_lo')            # mid-write
    rows, cur = read_metrics(run)
    assert len(rows) == 1
    with open(path, "a") as f:
        f.write('ss": 1.0}\n')
    assert read_metrics(run, since=cur)[0] == [{"step": 2,
                                                "train_loss": 1.0}]


def test_a_malformed_line_is_skipped(tmp_path):
    run = str(tmp_path / "r")
    os.makedirs(run)
    path = os.path.join(run, "train_metrics.jsonl")
    with open(path, "w") as f:
        f.write("not json\n")
    _log_rows(run, [(1, {"loss": 2.0})])
    rows, cur = read_metrics(run)
    assert len(rows) == 1 and cur == os.path.getsize(path)


def test_missing_files_and_roots(tmp_path):
    assert read_metrics(str(tmp_path)) == ([], 0)
    assert list_runs(str(tmp_path / "nowhere")) == []


@pytest.fixture
def root(tmp_path):
    _log_rows(str(tmp_path / "runA"), [(1, {"loss": 2.0}), (2, {"loss": 1.5})])
    _log_rows(str(tmp_path / "runB"), [(1, {"acc": 0.5})], prefix="test_")
    tcfg.tiny_test().save(str(tmp_path / "runA" / "config.json"))
    return str(tmp_path)


def test_the_server_on_port_0(root):
    srv = make_dashboard_server(root, port=0)
    try:
        runs = json.loads(_get(srv, "/api/runs")[1])["runs"]
        assert {r["name"] for r in runs} == {"runA", "runB"}
        assert [r for r in runs if r["name"] == "runA"][0]["has_config"]
        status, body = _get(srv, "/api/metrics?run=runA&since=0")
        j = json.loads(body)
        assert status == 200 and [r["step"] for r in j["rows"]] == [1, 2]
        assert json.loads(_get(
            srv, f"/api/metrics?run=runA&since={j['next']}")[1])["rows"] == []
        status, body = _get(srv, "/run?name=runA")
        assert status == 200 and b"sonet-torch monitor" in body
        status, body = _get(srv, "/")
        assert b"runA" in body and b"runB" in body
        body = _get(srv, "/api/metrics?run=..%2F..%2Fetc&since=0")[1]
        assert json.loads(body).get("error") == "unknown run"
    finally:
        srv.shutdown()
        srv.server_close()


def test_a_single_run_root_redirects(tmp_path):
    run = str(tmp_path / "only")
    _log_rows(run, [(1, {"loss": 1.0})])
    srv = make_dashboard_server(run, port=0)
    try:
        assert b"sonet-torch monitor" in _get(srv, "/")[1]
        rows = json.loads(_get(srv, "/api/metrics?run=.&since=0")[1])["rows"]
        assert rows[0]["train_loss"] == 1.0
    finally:
        srv.shutdown()
        srv.server_close()


def test_monitor_command(monkeypatch, tmp_path, capsys):
    from sonet_torch.tasks import monitor
    captured = {}
    real = make_dashboard_server

    def wrapper(root, **kw):
        captured["root"] = root
        srv = real(root, **kw)
        srv._thread = type("T", (), {"join": lambda self: None})()
        captured["srv"] = srv
        return srv

    monkeypatch.setattr(monitor, "make_dashboard_server", wrapper)
    run = str(tmp_path / "r")
    _log_rows(run, [(1, {"loss": 1.0})])
    assert tcli.main(["monitor", "--run", run, "--port", "0"]) == 0
    captured["srv"].shutdown()
    captured["srv"].server_close()
    assert captured["root"] == run
    assert "sonet-torch monitor on http://" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not a directory"):
        tcli.main(["monitor", "--root", str(tmp_path / "nowhere")])


def test_the_monitor_needs_no_torch(tmp_path):
    import subprocess
    code = ("import sys; import sonet_torch.tasks.monitor; "
            "assert 'torch' not in sys.modules, 'torch'")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr


def test_cli_lists_the_new_commands(capsys):
    assert tcli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "import-ckpt" in out and "monitor" in out


# ---------------------------------------------------------------------------
# diagnose_grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["classify", "segment"])
def test_diagnose_grads_matches_jax(task):
    over = dict(dropout=0.0) if task == "classify" else dict(
        task="segment", classes=50, dropout=0.0)
    cfg = tcfg.tiny_test().replace(**over)
    model = build_model(cfg, device="cpu").train()
    rs = np.random.RandomState(0)
    x = [torch.from_numpy(rs.randn(4, 64, 3).astype(np.float32)),
         torch.from_numpy(rs.randn(4, 64, 3).astype(np.float32)),
         torch.from_numpy(rs.randn(4, 16, 3).astype(np.float32))]
    if task == "segment":
        x.append(torch.tensor([0, 1, 2, 3]))
    out, _ = model(*x, epoch=0)
    (out ** 2).mean().backward()
    got = profiling.diagnose_grads(model)
    tree = {}
    for k, v in gradients_to_jax(model).items():
        _, *path, leaf = k.split("/")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    want = jprof.diagnose_grads(tree)
    assert set(got) == set(want) == {"encoder", "classifier" if task ==
                                     "classify" else "segmenter"}
    for k in want:
        assert got[k] > 0
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


# ---------------------------------------------------------------------------
# hlocat, tprof, trace, scan_bench, enable_nan_checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("want,name", H100_KERNELS)
def test_bucket_of_an_h100_kernel(want, name):
    assert hlocat.bucket(name) == want


def test_categorize_sums_by_bucket():
    per_op = {name: float(i + 1) for i, (_, name) in enumerate(H100_KERNELS)}
    per_op["a kernel of no bucket"] = 0.5
    per_op["idle"] = 0.0
    cats = hlocat.categorize(per_op)
    want = {}
    for i, (b, _) in enumerate(H100_KERNELS):
        want[b] = want.get(b, 0.0) + i + 1
    want["other"] += 0.5
    assert cats == pytest.approx(want)
    assert set(cats) == {"pooling kernel", "GEMMs", "sorts",
                         "copies and memsets", "Adam", "elementwise",
                         "BatchNorm statistics and other reductions", "other"}
    assert [n for _, n in hlocat.named_ops(per_op)][:2] == [
        H100_KERNELS[-1][1], H100_KERNELS[-2][1]]
    assert "idle" not in [n for _, n in hlocat.named_ops(per_op)]


def test_device_time_on_a_cpu_function(capsys):
    a = torch.randn(96, 96)
    total, per_op = tprof.device_time(lambda x: (x @ x).relu(), (a,),
                                      iters=3, top=2)
    assert total > 0 and total == pytest.approx(sum(per_op.values()))
    assert any("mm" in k for k in per_op)
    assert len(capsys.readouterr().out.splitlines()) == 2
    p = tprof.profile(lambda: a + 1, (), iters=2)
    assert not p.on_card and p.wall_ms > 0 and "aten::add" in p.launches
    assert p.launches["aten::add"] == 1.0


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_scan_bench_on_the_cpu(capsys):
    a = torch.randn(64, 64)
    ms = profiling.scan_bench(torch.mm, (a, a), iters=5, name="mm",
                              reps=3)
    assert ms > 0
    assert capsys.readouterr().out.startswith("mm: ")


def test_enable_nan_checks_raises_on_a_planted_nan():
    model = build_model(tcfg.tiny_test(), device="cpu")
    x = [torch.randn(4, 64, 3), torch.randn(4, 64, 3), torch.randn(4, 16, 3)]
    handle = profiling.enable_nan_checks()
    try:
        with torch.no_grad():
            model(*x)                               # finite: passes
        bad = x[1].clone()
        bad[0, 0, 0] = float("nan")
        with pytest.raises(FloatingPointError, match="non-finite output"):
            with torch.no_grad():
                model(x[0], bad, x[2])
        # the backward: sqrt's gradient at 0 is inf, masked to nan
        z = torch.zeros(3, requires_grad=True)
        y = torch.where(z > 0, torch.sqrt(z), z)
        with pytest.raises(RuntimeError, match="nan"):
            y.sum().backward()
    finally:
        handle.remove()
        torch.autograd.set_detect_anomaly(False)
    with torch.no_grad():
        model(x[0], bad, x[2])                      # checks off again
