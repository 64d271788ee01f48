"""BpDecoderBase: configuration, validation and property surface.

Port of ``ldpc_tpu.decoders.base``: the same constructor kwargs, string
aliases, properties, validation errors and the ldpc-v1 ``channel_probs``
hook, plus an explicit ``device`` on which the decoder's tensors live.
Every schedule (parallel, serial, serial-relative, random serial) runs in
float32 or float64: parallel float32 on kernel K1', parallel float64 on K8',
the serial schedules on K6' (:mod:`ldpc_tpu_torch.ops.bp`).
"""

import warnings
from typing import Optional, Union

import numpy as np
import scipy.sparse
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.helpers import convert_to_binary_sparse
from ldpc_tpu_torch.ops.pcm import PcmGraph, compile_pcm
from ldpc_tpu_torch.ops import bp as bp_ops
from ldpc_tpu_torch.utils.profiling import count, span, sync

_SYNDROME = 0
_RECEIVED_VECTOR = 1
_AUTO = 2


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _device_llrs(llrs, B: int, n: int, device) -> torch.Tensor:
    """(B, n) float32 LLRs on ``device`` for the standalone cluster
    decoders: a 1-D vector is shared by every row and broadcast there, None
    gives zeros made there."""
    if llrs is None:
        return torch.zeros((B, n), dtype=torch.float32, device=device)
    llrs = torch.as_tensor(np.asarray(llrs, dtype=np.float32), device=device)
    if llrs.dim() == 1:
        return llrs.expand(B, n)
    return llrs


class BpDecoderBase:
    """Belief-propagation decoder base: owns the PCM, channel and BP config."""

    # iterations of the cheap full-batch first phase of the decode_batch
    # cascade; the lanes that fail it re-run at full depth
    _CASCADE_ITERS = 6

    def __init__(self, pcm, **kwargs):
        error_rate = kwargs.pop("error_rate", None)
        error_channel = kwargs.pop("error_channel", None)
        max_iter = kwargs.pop("max_iter", 0)
        bp_method = kwargs.pop("bp_method", 0)
        ms_scaling_factor = kwargs.pop("ms_scaling_factor", 1.0)
        schedule = kwargs.pop("schedule", 0)
        omp_thread_count = kwargs.pop("omp_thread_count", 1)
        random_serial_schedule = kwargs.pop("random_serial_schedule", False)
        random_schedule_seed = kwargs.pop("random_schedule_seed", 0)
        serial_schedule_order = kwargs.pop("serial_schedule_order", None)
        channel_probs = kwargs.pop("channel_probs", [None])
        self._dtype = bp_ops.torch_dtype(kwargs.pop("dtype", torch.float32))
        self._device = resolve_device(kwargs.pop("device", "cuda"))

        if not isinstance(pcm, (np.ndarray, scipy.sparse.spmatrix)):
            raise TypeError(
                "The input matrix is of an invalid type. Please input "
                f"a np.ndarray or scipy.sparse.spmatrix object, not {type(pcm)}"
            )
        self._pcm = convert_to_binary_sparse(pcm)
        self.m, self.n = self._pcm.shape
        self._graph: Optional[PcmGraph] = None

        self._channel = np.zeros(self.n, dtype=np.float64)
        self._converge = False
        self._iter = 0
        self._log_prob_ratios = np.zeros(self.n)
        self._decoding = np.zeros(self.n, dtype=np.uint8)
        self._input_vector_type = _AUTO
        self.converge_batch = None
        self.iter_batch = None
        self._llr_batch = None  # device tensor, pulled on property access
        self._bp_batch = None  # full-depth BP decodings of the last cascade

        self._bp_method = 0
        self._schedule = bp_ops.PARALLEL
        self._max_iter = 0
        self._ms_scaling_factor = 1.0
        self._serial_schedule_order = None
        self._random_serial_schedule = False
        self._random_schedule_seed = 0
        self._omp_thread_count = 1
        self._decoder_cache = {}

        self.bp_method = bp_method
        self.max_iter = max_iter
        self.ms_scaling_factor = ms_scaling_factor
        self.schedule = schedule
        self.serial_schedule_order = serial_schedule_order
        if random_schedule_seed != 0 or random_serial_schedule:
            self.random_schedule_seed = random_schedule_seed
        self.omp_thread_count = omp_thread_count
        self.random_serial_schedule = random_serial_schedule

        # ldpc v1 backwards compatibility
        if isinstance(channel_probs, (list, np.ndarray)):
            if len(channel_probs) > 0 and channel_probs[0] is not None:
                error_channel = channel_probs

        if error_channel is not None:
            self.error_channel = error_channel
        elif error_rate is not None:
            self.error_rate = error_rate
        else:
            raise ValueError(
                "Please specify the error channel. Either: 1) error_rate: float "
                "or 2) error_channel: list of floats of length equal to the "
                f"block length of the code {self.n}."
            )

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    @property
    def pcm(self) -> scipy.sparse.csr_matrix:
        return self._pcm

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def graph(self) -> PcmGraph:
        if self._graph is None:
            self._graph = compile_pcm(self._pcm)
        return self._graph

    def _invalidate(self):
        self._decoder_cache.clear()

    def _bp_fn(self, iters: int):
        """The batched BP program of the current schedule and dtype at
        ``iters`` depth: ``decode(syndromes, init_llr)``."""
        key = ("bp", self._bp_method, self._schedule, self._random_serial_schedule,
               self._dtype, iters, float(self._ms_scaling_factor))
        fn = self._decoder_cache.get(key)
        if fn is None:
            args = (self.graph, self._bp_method, iters, self._ms_scaling_factor, self._device)
            if self._schedule == bp_ops.PARALLEL:
                fn = bp_ops.make_parallel_decoder(*args, dtype=self._dtype)
            else:
                serial = bp_ops.make_serial_decoder(
                    *args, schedule_mode=self._schedule,
                    random_serial_schedule=self._random_serial_schedule, dtype=self._dtype,
                )

                def fn(syn, init_llr, serial=serial):
                    return serial(syn, init_llr, self._schedule_array(), self._schedule_key())

            self._decoder_cache[key] = fn
        return fn

    def _schedule_array(self) -> np.ndarray:
        if self._serial_schedule_order is not None:
            return np.asarray(self._serial_schedule_order, dtype=np.int32)
        return np.arange(self.n, dtype=np.int32)

    def _schedule_key(self) -> Optional[torch.Generator]:
        """The random serial schedule's generator, seeded anew on each call
        (0: the clock), as the JAX package draws a key per call."""
        if not self._random_serial_schedule:
            return None
        return bp_ops.schedule_generator(self._random_schedule_seed, self._device)

    def _init_llr(self) -> torch.Tensor:
        llr = bp_ops.channel_llr(self._channel, dtype=np.float64)
        with sync("prior_h2d"):
            return torch.from_numpy(llr).to(device=self._device, dtype=self._dtype)

    def _run_bp_batch(self, syndromes, iters: Optional[int] = None):
        """Run batched BP on (B, m) syndromes; results stay on the device."""
        syn = torch.as_tensor(syndromes, dtype=torch.uint8, device=self._device)
        depth = self._max_iter if iters is None else iters
        return self._bp_fn(depth)(syn, self._init_llr())

    def _coerce_batch_syndromes(
        self, syndromes: np.ndarray, bit_packed: bool
    ) -> np.ndarray:
        """Normalise a syndrome batch to (B, m) uint8, unpacking
        little-endian bit-packed input (stim b8 layout) when asked."""
        if bit_packed:
            Wm = -(-self.m // 8)
            packed = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
            if packed.shape[1] != Wm:
                raise ValueError(
                    f"Bit-packed syndromes must have shape (batch, {Wm}). "
                    f"Not {packed.shape}."
                )
            return np.unpackbits(
                packed, axis=1, count=self.m, bitorder="little"
            )
        return np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))

    def _decode_cascade(self, syndromes: np.ndarray, post_fn=None) -> tuple:
        """Decode a (B, m) uint8 batch with the two-phase BP cascade and
        run ``post_fn`` on the lanes full-depth BP fails.

        Port of ``_postprocess_cascade_batch`` (the JAX package's fused TPU
        cascade computes the same):

        1. phase-1 BP at ``_CASCADE_ITERS`` iterations over the whole batch;
        2. the lanes that failed it are compacted (exactly: ``torch.nonzero``);
        3. full-depth BP re-runs on those lanes only;
        4. ``post_fn(syndromes_f, llrs_f)`` runs on the lanes that still
           fail, with their full-depth posteriors, and returns a tuple of
           (F, n) uint8 decodings;
        5. each is merged into the BP decodings;
        6. zero-syndrome rows decode to zero and count as converged.

        Per-lane BP is deterministic, so the output equals one full-depth
        run followed by ``post_fn`` on its failures. Each compaction costs
        one host sync. With the recorder on (:mod:`ldpc_tpu_torch.utils.profiling`)
        the stages are the spans ``bp.phase1``, ``bp.phase2``,
        ``decoder.merge`` and ``decoder.store``, and each host sync (the
        syndromes' copy ``sync.syndromes_h2d`` first) is a ``sync.<cause>``
        span. Returns one (B, n) uint8 device tensor per decoding
        ``post_fn`` returned, or the BP decodings alone (a one-tuple) when
        ``post_fn`` is None or no lane needed it. Stores the batch
        properties: ``converge_batch``, ``iter_batch``, the posteriors and
        the full-depth BP decodings.
        """
        with sync("syndromes_h2d"):
            syn = torch.from_numpy(syndromes).to(self._device)
        return self._decode_cascade_device(syn, post_fn)

    def _decode_cascade_device(self, syn: torch.Tensor, post_fn=None) -> tuple:
        """:meth:`_decode_cascade` on (B, m) uint8 syndromes already on the
        decoder's device: no copy of the batch in, device tensors out."""
        nonzero = (syn != 0).any(dim=1)
        bp, failed = self._run_bp_two_phase(syn, ~nonzero)
        dec, llr, conv, iters = bp
        outs = (dec,)
        post = None
        if post_fn is not None and failed.numel():
            post = post_fn(syn[failed], llr[failed])
        with span("decoder.merge"):
            if post is not None:
                outs = tuple(dec.index_put((failed,), p.to(dec.dtype)) for p in post)
            keep = nonzero[:, None].to(dec.dtype)
            outs = tuple(o * keep for o in outs)
        with span("decoder.store"):
            self._store_batch(conv, iters, llr, dec)
        return outs

    def _run_bp_two_phase(self, syn: torch.Tensor, done: torch.Tensor):
        """BP on (B, m) device syndromes in two phases: ``_CASCADE_ITERS``
        iterations on the whole batch, then full depth on the lanes that
        failed it, compacted. Lanes flagged in ``done`` count as converged
        after phase 1. Per-lane BP is deterministic, so the result equals
        one full-depth run. Only the parallel float32 schedule cascades, as
        in the JAX package; the others run once at full depth (a random
        serial schedule draws its permutations per run). Returns ``(BpResult
        with the merged results, the indices of the lanes full-depth BP
        fails)``; one or two host syncs (``sync.phase1_compact``,
        ``sync.phase2_compact``), and the prior's copy a phase
        (``sync.prior_h2d``)."""
        cascade = self._schedule == bp_ops.PARALLEL and self._dtype == torch.float32
        p1 = min(self._CASCADE_ITERS, self._max_iter) if cascade else self._max_iter
        with span("bp.phase1"):
            bp = self._run_bp_batch(syn, p1)
            dec, llr = bp.decoding, bp.llr_posterior
            conv, iters = bp.converged | done, bp.iterations
            with sync("phase1_compact"):
                failed = torch.nonzero(~conv).squeeze(1)
        if failed.numel() and p1 < self._max_iter:
            count("lanes.phase2", failed.numel())
            with span("bp.phase2"):
                bp2 = self._run_bp_batch(syn[failed])
                dec = dec.index_put((failed,), bp2.decoding)
                llr = llr.index_put((failed,), bp2.llr_posterior)
                conv = conv.index_put((failed,), bp2.converged)
                iters = iters.index_put((failed,), bp2.iterations)
                with sync("phase2_compact"):
                    failed = failed[~bp2.converged]
        return bp_ops.BpResult(dec, llr, conv, iters), failed

    def _store_batch(self, conv, iters, llr, bp_dec) -> None:
        """Keep a batch's BP results for the properties (device tensors in)."""
        with sync("store_converge"):
            self.converge_batch = _to_numpy(conv)
        with sync("store_iter"):
            self.iter_batch = _to_numpy(iters)
        self._llr_batch = llr
        self._bp_batch = bp_dec
        self._converge = bool(self.converge_batch[0])
        self._iter = int(self.iter_batch[0])
        with sync("store_llr0"):
            self._log_prob_ratios = _to_numpy(llr[0])

    def _store_single_result(self, result: bp_ops.BpResult):
        self._converge = bool(result.converged[0])
        self._iter = int(result.iterations[0])
        self._log_prob_ratios = _to_numpy(result.llr_posterior[0])
        self._decoding = _to_numpy(result.decoding[0])

    # ------------------------------------------------------------------
    # properties (reference parity)
    # ------------------------------------------------------------------
    @property
    def log_prob_ratios_batch(self) -> Optional[np.ndarray]:
        """Posterior LLRs of the last batch (pulled from the device)."""
        if self._llr_batch is None:
            return None
        return _to_numpy(self._llr_batch)

    @property
    def error_rate(self) -> np.ndarray:
        return self._channel.astype(float).copy()

    @error_rate.setter
    def error_rate(self, value: Optional[float]) -> None:
        if value is not None:
            if not isinstance(value, float):
                raise ValueError(
                    "The `error_rate` parameter must be specified as a single float value."
                )
            self._channel[:] = value

    @property
    def error_channel(self) -> np.ndarray:
        return self._channel.astype(float).copy()

    @error_channel.setter
    def error_channel(self, value) -> None:
        if value is not None:
            if len(value) != self.n:
                raise ValueError(
                    f"The error channel vector must have length {self.n}, not {len(value)}."
                )
            self._channel[:] = np.asarray(value, dtype=np.float64)

    def update_channel_probs(self, value) -> None:
        self.error_channel = value

    @property
    def channel_probs(self) -> np.ndarray:
        return self._channel.astype(float).copy()

    @property
    def input_vector_type(self) -> str:
        if self._input_vector_type == _SYNDROME:
            return "syndrome"
        if self._input_vector_type == _RECEIVED_VECTOR:
            return "received_vector"
        return "auto"

    @input_vector_type.setter
    def input_vector_type(self, input_type: str):
        if input_type.lower() in ("auto", "a", "2"):
            if self.m == self.n:
                raise ValueError(
                    "Please specify the input vector type. Either: 1) "
                    "input_vector_type: 'syndrome' or 2) input_vector_type: "
                    "'received_vector'."
                )
            self._input_vector_type = _AUTO
        elif input_type.lower() in ("syndrome", "s", "0"):
            self._input_vector_type = _SYNDROME
        elif input_type.lower() in ("received_vector", "r", "1"):
            self._input_vector_type = _RECEIVED_VECTOR
        else:
            raise ValueError(
                f"The input vector type '{input_type}' is invalid. Please choose "
                "from the following methods: 'input_vector_type=syndrome', "
                "'input_vector_type=received_vector'"
            )

    @property
    def log_prob_ratios(self) -> np.ndarray:
        return np.asarray(self._log_prob_ratios)

    @property
    def converge(self) -> bool:
        return self._converge

    @property
    def iter(self) -> int:
        return self._iter

    @property
    def check_count(self) -> int:
        return self.m

    @property
    def bit_count(self) -> int:
        return self.n

    @property
    def max_iter(self) -> int:
        return self._max_iter

    @max_iter.setter
    def max_iter(self, value: int) -> None:
        if not isinstance(value, int):
            raise ValueError(
                "max_iter input parameter is invalid. This must be specified as a positive int."
            )
        if value < 0:
            raise ValueError(
                f"max_iter input parameter must be a positive int. Not {value}."
            )
        self._max_iter = value if value != 0 else self.n
        self._invalidate()

    @property
    def bp_method(self) -> str:
        return "product_sum" if self._bp_method == bp_ops.PRODUCT_SUM else "minimum_sum"

    @bp_method.setter
    def bp_method(self, value: Union[str, int]) -> None:
        sval = str(value).lower()
        if sval in ("prod_sum", "product_sum", "ps", "0", "prod sum"):
            self._bp_method = bp_ops.PRODUCT_SUM
        elif sval in ("min_sum", "minimum_sum", "ms", "1", "minimum sum", "min sum"):
            self._bp_method = bp_ops.MINIMUM_SUM
        else:
            raise ValueError(
                f"BP method '{value}' is invalid. Please choose from the "
                "following methods: 'product_sum', 'minimum_sum'"
            )
        self._invalidate()

    @property
    def schedule(self) -> str:
        return {0: "serial", 1: "parallel", 2: "serial_relative"}[self._schedule]

    @schedule.setter
    def schedule(self, value: Union[str, int]) -> None:
        sval = str(value).lower()
        if sval in ("parallel", "p", "0"):
            self._schedule = bp_ops.PARALLEL
        elif sval in ("serial", "s", "1"):
            self._schedule = bp_ops.SERIAL
        elif sval in ("serial_relative", "sr", "2"):
            self._schedule = bp_ops.SERIAL_RELATIVE
        else:
            raise ValueError(
                f"The BP schedule method '{value}' is invalid. Please choose "
                "from the following methods: 'schedule=parallel', "
                "'schedule=serial', 'schedule=serial_relative'"
            )
        self._invalidate()

    @property
    def serial_schedule_order(self) -> Union[None, np.ndarray]:
        if self._serial_schedule_order is None:
            return None
        return np.asarray(self._serial_schedule_order).astype(int)

    @serial_schedule_order.setter
    def serial_schedule_order(self, value) -> None:
        if value is None:
            self._serial_schedule_order = None
            self._invalidate()
            return
        if not len(value) == self.n:
            raise Exception(
                "Input error. The `serial_schedule_order` input parameter must "
                "have length equal to the length of the code."
            )
        arr = np.zeros(self.n, dtype=np.int32)
        for i in range(self.n):
            if (
                not isinstance(value[i], (int, np.int64, np.int32))
                or value[i] < 0
                or value[i] >= self.n
            ):
                raise ValueError(
                    f"serial_schedule_order[{i}] is invalid. It must be a "
                    f"non-negative integer less than {self.n}."
                )
            arr[i] = value[i]
        self._serial_schedule_order = arr
        self._random_serial_schedule = False
        self._invalidate()

    @property
    def ms_scaling_factor(self) -> float:
        return self._ms_scaling_factor

    @ms_scaling_factor.setter
    def ms_scaling_factor(self, value: float) -> None:
        if not isinstance(value, (float, int)):
            raise TypeError("The ms_scaling factor must be specified as a float")
        self._ms_scaling_factor = float(value)
        self._invalidate()

    @property
    def omp_thread_count(self) -> int:
        return self._omp_thread_count

    @omp_thread_count.setter
    def omp_thread_count(self, value: int) -> None:
        if not isinstance(value, int) or value < 1:
            raise TypeError(
                "The omp_thread_count must be specified as a positive integer."
            )
        self._omp_thread_count = value
        if self._omp_thread_count != 1:
            warnings.warn(
                "The OpenMP functionality is not implemented: parallelism "
                "comes from batching on the device, not threads."
            )

    @property
    def random_schedule_seed(self) -> int:
        return self._random_schedule_seed

    @random_schedule_seed.setter
    def random_schedule_seed(self, value: int) -> None:
        if not isinstance(value, int) or value < -2:
            raise ValueError(
                "The value of random_schedule_seed must be a positive integer. "
                "Set as -1 to disable to the random schedule. Set as 0 to use "
                "the system clock."
            )
        self._random_serial_schedule = True
        self._random_schedule_seed = value
        self._invalidate()

    @property
    def random_serial_schedule(self) -> bool:
        return self._random_serial_schedule

    @random_serial_schedule.setter
    def random_serial_schedule(self, value: bool) -> None:
        self._random_serial_schedule = value
        self._invalidate()

    @property
    def decoding(self) -> np.ndarray:
        return np.asarray(self._decoding).astype(int)
