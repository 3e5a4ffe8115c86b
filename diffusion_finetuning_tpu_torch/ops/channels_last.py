"""The channels-last (NHWC) layout of the generation path.

On the card the pipeline hands the UNet its latents and the VAE its input in
``torch.channels_last`` (:func:`card_layout`) and runs them inside
:func:`scope`; there the modules of the conv path (``models/layers.py``:
``Conv2d``, ``LoRAConv2d``, ``GroupNorm``) take the layout of the activation
they receive (:func:`takes_nhwc`): channels-last keeps it, through
convolutions that read a channels-last copy of their filter and the NHWC
GroupNorm (``ops/group_norm.py``); NCHW runs the NCHW code.  Logical shapes
stay NCHW everywhere: only the strides differ.

Outside the scope the modules run the NCHW code whatever the strides of
their input.  The layout alone cannot tell a generation call from a training
one: the trainers' latents, noise and pixels are permuted views of the JAX
package's NHWC arrays, so they lie channels-last too (``training/loss.py``),
and so does the view the SD 1.5 transformers hand ``proj_out``.  The scope
is temporary: it keeps the trainers on the operations they ran before this
path existed, bit for bit, until their channels-last step (a backward of
the NHWC GroupNorm) lands; then the layout alone decides and the scope goes.

**Filters.**  cuDNN runs bf16 convolutions on NHWC engines; given an NCHW
filter with a channels-last input, PyTorch copies the filter to channels-last
on every call.  :func:`channels_last_filter` keeps that copy per weight,
made once at first use (a graph's warm-up, outside any graph's pool; asked
for while a graph is being captured it raises), by the rule the fused conv's
tap-major copies and ``graph.ParamBuffers`` follow: a copy belongs to the
weight object and to its ``_version``.  An eager call rewrites a stale copy
in place.  A CUDA graph reads the copy it was captured with and runs no
Python, so the two places that write a graph's weights in place rewrite
their copies at once (:func:`refresh`): ``graph.ParamBuffers.fill`` (a
merged adapter's weights refilled) and ``layers.Conv2d``'s state-dict load.
A freed weight drops its copy.  Module parameters stay NCHW and contiguous:
state dicts, saves and the trainers see them as they were.

**Counters** (module integers, counted per Python call, so per capture and
per eager call, and read by ``trainer_util.DispatchLog.summary``):
:data:`calls`, the convolutions (a LoRA'd conv layer makes three) and
GroupNorms of the UNet and VAE that ran on a channels-last activation;
:data:`fallbacks`, those GroupNorms on a CUDA tensor that needed a gradient
and so ran PyTorch's GroupNorm (the NHWC kernel is forward only; a CUDA call
it does not take otherwise raises); :data:`filter_copies`, the channels-last
filters made or rewritten.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
import torch

calls = 0
fallbacks = 0
filter_copies = 0

_FILTERS = {}  # id(weight) -> [weakref to the weight, its _version, channels-last copy]
_LOCK = threading.Lock()


def is_nhwc(x: torch.Tensor) -> bool:
    """Whether 4-D ``x`` lies channels-last and not also NCHW (a tensor with
    one channel or one pixel is both, and takes the NCHW code)."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


_state = threading.local()  # .on: inside scope() on this thread


def active() -> bool:
    """Whether this thread runs inside :func:`scope`."""
    return getattr(_state, "on", False)


@contextlib.contextmanager
def scope(on: bool = True):
    """Run the block with the conv path keeping channels-last activations
    channels-last (``on``), or with the NCHW code throughout."""
    prev = active()
    _state.on = on
    try:
        yield
    finally:
        _state.on = prev


def takes_nhwc(x: torch.Tensor) -> bool:
    """Whether a conv-path module runs its channels-last code on ``x``:
    inside :func:`scope`, on a channels-last ``x``."""
    return active() and is_nhwc(x)


def card_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` channels-last on the card, as it is elsewhere: what the
    pipeline hands the UNet and the VAE."""
    return x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x


def _copy(weight: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode(False), torch.no_grad():
        return weight.detach().clone(memory_format=torch.channels_last)


def _rewrite(entry: list, weight: torch.Tensor) -> None:
    global filter_copies
    if weight.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a channels-last filter was made or rewritten while a CUDA graph is "
                           "being captured: warm up on the capture stream first")
    with torch.inference_mode(False), torch.no_grad():
        entry[2].copy_(weight)
    entry[1] = weight._version
    filter_copies += 1


def channels_last_filter(weight: torch.Tensor) -> torch.Tensor:
    """The channels-last copy of conv ``weight`` (O, C, kh, kw), cached.
    A weight already channels-last (a 1x1 filter is both layouts at once)
    or one that takes a gradient here is returned as it is (PyTorch's
    conversion is differentiable); an inference tensor, which has no
    version counter, is copied at every call."""
    global filter_copies
    if (weight.is_contiguous(memory_format=torch.channels_last)
            or (torch.is_grad_enabled() and weight.requires_grad)):
        return weight
    if weight.is_inference():
        return weight.contiguous(memory_format=torch.channels_last)
    key = id(weight)
    entry = _FILTERS.get(key)
    if entry is not None and entry[0]() is weight:
        if entry[1] != weight._version:
            with _LOCK:
                _rewrite(entry, weight)
        return entry[2]
    if weight.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a channels-last filter was asked for while a CUDA graph is being "
                           "captured: warm up on the capture stream first")
    with _LOCK:
        entry = [weakref.ref(weight, lambda ref, k=key: _drop(k, ref)),
                 weight._version, _copy(weight)]
        _FILTERS[key] = entry
        filter_copies += 1
    return entry[2]


def _drop(key: int, ref: weakref.ref) -> None:
    """A freed weight's copy goes, unless its id already names another's."""
    entry = _FILTERS.get(key)
    if entry is not None and entry[0] is ref:
        del _FILTERS[key]


def refresh(weight: torch.Tensor) -> None:
    """After an in-place write to ``weight``, rewrite its cached
    channels-last copy in place (the same tensor, which a CUDA graph may
    read) on the current stream; a weight with no cached copy is left
    alone."""
    entry = _FILTERS.get(id(weight))
    if entry is not None and entry[0]() is weight and entry[1] != weight._version:
        with _LOCK:
            _rewrite(entry, weight)
