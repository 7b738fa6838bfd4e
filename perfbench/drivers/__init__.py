"""One driver per kind of cell. A cell's file names its driver
(``"driver"``) and holds the parameters the driver reads; each driver's
``run(rc)`` takes a ``harness.run.RunContext`` and returns a
``harness.run.RunResult``."""
