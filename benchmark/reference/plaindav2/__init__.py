"""The plain reference of the Depth Anything V2 cells: DINOv2 ViT-L/14 and
the DPT head in functional PyTorch, float32 with TF32 off
(`depth_anything.py`, which the tests hold the port to as well), and the
controls its comparison must fail (`control.py`). Nothing here imports the
port."""
