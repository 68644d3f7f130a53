"""Program kinds: ``<kind>.py`` is the system under test as a cell runs it,
named by the cell's configuration (``"program": "<kind>"``), with its
plain reference.  The only modules of the benchmark that import the
program, and only inside their functions: the benchmark's own tests
import them where the program is absent.

A kind is added as one file that gives:

* ``Session(cell, seed, device, trace, tracer=None)``: the program set up
  for the cell, from the seed.  ``.program`` (what it set up),
  ``.inputs`` (what the harness drew that the reference also takes),
  ``.planes(index)`` (frame ``index``'s inputs, drawn from ``(seed,
  index)``; warm-up frames take negative indices), ``.render(planes) ->
  (image [H, W, C], counters [n])`` on the host (``n`` may be 0),
  ``.setup_done()`` (after the warm-up), ``.frame_done()`` (after each
  frame of the window), ``.run_fields()`` (the ``record.Run`` fields the
  kind fills: ``diffuse``, ``guide_ms``) and ``.close()``;
* ``Reference(cell, seed, device, inputs, precision=None,
  count_work=False)``: plain PyTorch or NumPy that imports nothing of the
  program.  ``.frame(index)`` gives the reference's image and counters
  for that frame, drawn anew from the seed; ``.work_per_frame()`` the work
  it counted (``record.Run.work``) or None.  ``precision="control"`` is
  the control: the reference at the precision below the configuration's,
  which the cell's limits must fail;
* ``samples_per_frame(cell)``: the units a frame completes, which
  ``samples_per_s`` counts.
"""
