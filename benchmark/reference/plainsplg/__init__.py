"""The plain reference of the SuperPoint + LightGlue cells: both networks
in functional PyTorch, float32 with TF32 off (`superpoint_lightglue.py`,
which the tests hold the port to as well), and the controls its comparison
must fail (`control.py`). Nothing here imports the port."""
