"""Engine facade over the Session/Plan API (port of ``repro.core.engine``).

:class:`NXGraphEngine` binds one (graph, program) pair to a session and
forwards ``run()`` to ``session.run(plan)``. It is kept for callers of the
engine-style API (the scripts of ``benchmarks/`` and ``examples/`` use it);
new code stages a :class:`~repro_torch.core.session.GraphSession` once and
runs plans against it::

    session = GraphSession(graph, memory_budget=...)
    result = session.run(ExecutionPlan(PageRank(), max_iters=20, tol=0.0))

``Meters`` and ``Result`` are re-exported unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.core.dsss import DSSSGraph
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.session import GraphSession, Meters, Result
from repro_torch.device import resolve_device

__all__ = ["NXGraphEngine", "Meters", "Result"]


class NXGraphEngine:
    """The NXgraph engine over a :class:`DSSSGraph`, one program (shim).

    Args:
      graph: sharded graph.
      program: vertex program (semiring decomposition of Update).
      strategy: "auto" | "spu" | "dpu" | "mpu" | "fused" | a registered
        custom strategy. "auto" applies the paper's adaptive selection from
        ``memory_budget``.
      memory_budget: bytes of fast-tier memory (B_M). ``None`` = unlimited.
      residency: "device" | "host" | "disk" | "auto" (see
        :class:`GraphSession`; ``"auto"`` with a budget means host
        residency, which streams the unpinned edge topology every sweep;
        ``"disk"`` needs a shared ``session`` opened with
        :meth:`GraphSession.open`). ``None`` is "auto".
      execution: "per_block" | "packed" | "packed_kernel" | "auto", a
        per-plan override (see :class:`GraphSession`). ``None`` inherits
        the session's.
      packing: "adaptive" | "subshard" | "auto" tile layout; ``None`` is
        "auto".
      Be: bytes per edge in the I/O model (8 = two int32 ids).
      Bv: bytes per vertex id.
      session: share an existing staged session instead of staging one.
      device: where a new session stages the graph; ``None`` is the CUDA
        card (raises without one). With ``session=``, it must name the
        session's device.
    """

    def __init__(
        self,
        graph: DSSSGraph,
        program,
        *,
        strategy: str = "auto",
        memory_budget: int | None = None,
        residency: str | None = None,
        execution: str | None = None,
        packing: str | None = None,
        Be: int | None = None,
        Bv: int | None = None,
        session: GraphSession | None = None,
        device: str | torch.device | None = None,
    ):
        if session is None:
            session = GraphSession(
                graph,
                device=device,
                memory_budget=memory_budget,
                residency="auto" if residency is None else residency,
                packing="auto" if packing is None else packing,
                Be=8 if Be is None else Be,
                Bv=4 if Bv is None else Bv,
            )
        else:
            # A shared session fixes staging and the I/O model's sizes;
            # refuse arguments that would otherwise be ignored.
            if session.graph is not graph:
                raise ValueError(
                    "session was staged for a different graph object than `graph`"
                )
            if device is not None and resolve_device(device) != session.device:
                raise ValueError(
                    f"device={device!r} conflicts with the shared session's "
                    f"device ({session.device}); configure it on the GraphSession"
                )
            if residency is not None and session.resolved_residency(
                residency
            ) != session.resolved_residency():
                raise ValueError(
                    f"residency={residency!r} conflicts with the shared "
                    f"session's residency ({session.residency!r}); configure "
                    "it on the GraphSession"
                )
            if memory_budget is not None and memory_budget != session.memory_budget:
                raise ValueError(
                    f"memory_budget={memory_budget} conflicts with the shared "
                    f"session's budget ({session.memory_budget}); configure the "
                    "budget on the GraphSession"
                )
            expect_Be = None if Be is None else Be + (4 if session.has_weights else 0)
            if expect_Be is not None and expect_Be != session.Be:
                raise ValueError(
                    f"Be={Be} conflicts with the shared session's edge size; "
                    "configure Be on the GraphSession"
                )
            if Bv is not None and Bv != session.Bv:
                raise ValueError(
                    f"Bv={Bv} conflicts with the shared session's vertex-id "
                    "size; configure Bv on the GraphSession"
                )
            if packing is not None and packing != "auto" and packing != session.packing:
                raise ValueError(
                    f"packing={packing!r} conflicts with the shared session's "
                    f"tile packing ({session.packing!r}); configure it on the "
                    "GraphSession"
                )
        self.session = session
        self.g = graph
        self.program = program
        self.memory_budget = session.memory_budget
        self._strategy = strategy
        # A per-plan override: a shared session keeps its own default.
        self._execution = execution
        compiled = session.compile(
            ExecutionPlan(program, strategy=strategy, execution=execution)
        )
        self.params = compiled.params
        self.choice = compiled.choice
        self.resident = compiled.resident
        self.execution = compiled.execution

    # -- staged state (the shared session's) ---------------------------------
    @property
    def blocks(self):
        return self.session.blocks

    @property
    def Be(self) -> int:
        return self.session.Be

    @property
    def Bv(self) -> int:
        return self.session.Bv

    @property
    def has_weights(self) -> bool:
        return self.session.has_weights

    # -- public API ----------------------------------------------------------
    def run(
        self,
        max_iters: int = 200,
        tol: float = 1e-10,
        checkpoint=None,
        resume_from=None,
        cancel=None,
        **program_kwargs,
    ) -> Result:
        """Forward to ``session.run``.

        ``checkpoint`` (a :class:`repro_torch.reliability.CheckpointSpec`),
        ``resume_from`` and ``cancel`` pass straight through to the
        session's reliability machinery: see :meth:`GraphSession.run`.
        """
        plan = ExecutionPlan(
            self.program,
            strategy=self._strategy,
            max_iters=max_iters,
            tol=tol,
            execution=self._execution,
            checkpoint=checkpoint,
            program_kwargs=program_kwargs,
        )
        return self.session.run(plan, resume_from=resume_from, cancel=cancel)
