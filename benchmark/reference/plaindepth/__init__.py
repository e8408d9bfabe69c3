"""The plain reference of the depth cells: MonoDepth2 in functional
PyTorch, float32 with TF32 off (`monodepth2.py`, which the tests hold the
port to as well), and the controls its comparison must fail (`control.py`).
Nothing here imports the port."""
