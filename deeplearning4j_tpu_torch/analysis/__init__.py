"""graftlint, the runtime sanitizers and graftaudit for the port (the
JAX package's ``deeplearning4j_tpu/analysis/``, with each bug class given
its PyTorch meaning).

The reference's tooling is about jaxprs, ``jax.jit`` caches and
``np.asarray`` readbacks. What each of its concepts is in the port:

- **A host sync** is any call that makes the host wait for the card to
  hand it a value: ``Tensor.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``float()``/``int()``/``bool()`` of a tensor,
  ``np.asarray``/``np.array`` of a tensor, a blocking ``.to("cpu")`` or
  ``copy_`` out of the card, ``torch.cuda.synchronize`` and the
  ``synchronize`` of a CUDA event or stream, and the ops that size their
  output from the data (``nonzero``, ``masked_select``, ``unique``, ...:
  the host must learn the size before it can allocate). The engine
  budgets one a horizon, the token block's event in its process phase
  (on the CPU, where there is no event, the block's ``.numpy()``).
- **A zero-copy alias** is a tensor over a numpy buffer that is mutated
  elsewhere: ``torch.from_numpy(buf)``, ``torch.as_tensor(buf)`` and the
  port's ``upload`` (``torch.from_numpy`` on the CPU) share the buffer, so
  a later host write changes what a program reads or what device state
  holds; on the card, a non-blocking copy out of a pinned alias reads it
  whenever the stream gets to it. The engine snapshots (``.copy()``)
  every host mirror it uploads.
- **PRNG reuse** is a threefry key of the port's ``ops/threefry.py`` or
  ``rng.py`` (the reference's key stream: pure values, as JAX's keys are)
  consumed by two sinks without a ``split``/``fold_in``. A
  ``torch.Generator`` is stateful: each draw advances it, so drawing twice
  from one is not reuse, and the rule does not track generators (none is
  on a serving path; the port draws from threefry keys).
- **A retrace hazard.** The port has no jit, so nothing retraces. Its
  counterpart is one-time work done per call: a kernel build
  (``ops/_build.py``), a CUDA-graph capture or a ``torch.compile``/
  ``torch.jit`` reached from a loop or a ``# lint: hot-path`` function,
  or compiled and invoked at once. At run time the programs are keyed all
  the same (the kernels and the library pick their code by shape, a probe
  gates each batched geometry once): ``CompileCountGuard`` holds the
  engine's dispatched keys to the reference's families.
- **A program family** is one of the engine's ``build_*_program``
  factories at one shape key, the names its ``_attr`` and
  ``metrics.record_program`` use: ``step``/``masked_step`` keyed by the
  horizon K (``paged_`` variants with the paged pool), ``prefill``/
  ``paged_prefill`` and ``chunk`` by the prompt bucket, ``batch_prefill``
  and ``batch_hit`` by (bucket, padded group), and the unkeyed copies
  (insert, hit insert, segment fetch/store/import, logit row, gstate set,
  deactivate, replay). ``analysis/programs.py`` enumerates them;
  ``analysis/audit.py`` traces each on ``meta`` tensors (nothing runs),
  with the hand-written kernels (#1, #3, #4 and the threefry draw) seen as
  one op each at the flops and bytes of their bound.

All five lint rules exist with these meanings; a rule whose bug class the
port cannot hit still runs and its test shows it fires on its pattern.
Static rules are pure-stdlib ``ast`` passes (no imports of the linted
code), run via ``python -m deeplearning4j_tpu_torch lint`` against
``analysis/lint_baseline.json``. Runtime sanitizers (:mod:`.sanitizers`)
are opt-in and zero-cost when off: the disabled path is a single global
``None`` check.
"""

from deeplearning4j_tpu_torch.analysis.baseline import Baseline
from deeplearning4j_tpu_torch.analysis.core import Finding, ModuleInfo
from deeplearning4j_tpu_torch.analysis.rules import RULES, run_rules
from deeplearning4j_tpu_torch.analysis.sanitizers import (
    CompileCountGuard,
    LockSanitizer,
    SanitizerViolation,
    SyncSanitizer,
    note_access,
    wrap_lock,
)

__all__ = [
    "Baseline",
    "CompileCountGuard",
    "Finding",
    "LockSanitizer",
    "ModuleInfo",
    "RULES",
    "SanitizerViolation",
    "SyncSanitizer",
    "note_access",
    "run_rules",
    "wrap_lock",
]
