"""The benchmark's inputs (``data``), its plain float64 reference and the
TF32 control (``plain``), and the comparison that decides ``correct``
(``compare``).  Nothing here imports the program."""
