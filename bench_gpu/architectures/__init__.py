"""Architectures: what the harness knows of one model's design, one module
a design, found by file.

A configuration file (``configs/<config>.json``) names its architecture
with the key ``"architecture"``; without it the architecture is
``"mdgat"``. The harness loads ``architectures/<architecture>.py`` by path
(``harness/common.py::architecture``), as it loads ``metrics/<name>.py``,
so a configuration of another design joins the benchmark as new files
alone: ``configs/<config>.json``, ``architectures/<architecture>.py``,
``workloads/<cell>.json`` and ``metrics/<metric>.py``. The three loops of
``harness/cells.py`` (``train``, ``match``, ``eval``) and
``checks.judge`` call the module and read none of the design's keys.

The contract. A module provides:

``sizes(config) -> dict``
    What the reference, the weights and the work counts read, from the
    configuration file's contents. The loops read two keys of it:
    ``threshold`` (the ground truth's match distance, as the program's
    ``Config.threshold``) and, in a ``train`` cell, ``learning_rate``.

``param_specs(sizes) -> [(name, shape, init, arg), ...]``
    Every tensor of the program's state dict, which loads the weights with
    ``strict=True``. ``init`` is ``uniform`` (U(-1/sqrt(arg), 1/sqrt(arg)),
    ``arg`` the fan-in), ``normal`` (N(0, 1) times ``arg``), ``one``,
    ``zero``, ``bin`` (1) or ``count`` (an int64 zero).

``gain(name, config) -> float``
    The factor on the scale of the ``uniform`` or ``normal`` tensor
    ``name``.

``program_fields(config) -> dict``
    The program's ``Config`` fields (tuples where ``Config`` keeps
    tuples): the ``match`` kind hands them to ``api.Matcher``, the
    ``train`` and ``eval`` kinds to ``Config.replace``; the eval kind builds
    its model with ``models/factory.py::build_model``.

``reference_match(weights, sizes, x, prec) -> ((dense, bin_row, bin_col),
(matches0, matches1, scores0, scores1))``
    The plain reference's log assignment with dustbins (``dense`` [B, N,
    M], ``bin_row`` [B, M], ``bin_col`` [B, N]) and its decision (-1
    unmatched), over the inputs ``x`` (``reference.inputs``, with the
    ground truth where the batch has world keypoints) at ``prec``
    (``reference.Precision``).

``reference_train(weights, sizes, batches, prec, lr, loss_rows) ->
(losses, first gradients, parameters after)``
    ``len(batches)`` optimizer steps of the reference from ``weights``,
    each loss the mean of the per-pair loss over the first ``loss_rows``
    pairs (all when None); gradients and parameters by state-dict name.

``reference_loss(sizes, transport, x) -> [B]``
    The per-pair loss the program's eval forward reports (``loss``), from
    the reference's log assignment: the eval kind's ``loss_gap``.

``match_readings(sizes, answers, masks, transport) -> {name: float}``
    The numbers that hold the program's answers (``matches0``,
    ``matches1``, ``matching_scores0``, ``matching_scores1``, stacked) to
    the reference's log assignment over the valid rows and columns
    (``masks``), by the design's own decision; ``checks.judge`` compares
    those the workload file gives a limit.

``work(sizes, host, train) -> {key: float}``
    The work of one stacked host batch: ``pairs``, ``flops`` (what
    ``mfu.*`` reads) and any bound in seconds a roofline metric reads.
    ``work.per_iteration`` sums whatever keys it is given, so a new key
    reaches a new metric file with no edit.

``eval_readings(model, x, dtype, device) -> {name: float}``
    Readings of the eval kind's model outside the window, in a traced run,
    for ``Readings.extra`` (``x`` the forward's inputs of one pool batch);
    ``{}`` where the design has none.
"""
