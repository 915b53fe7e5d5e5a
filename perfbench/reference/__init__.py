"""The benchmark's plain PyTorch reference of MCAQ-YOLO: float32, no
hand-written kernel, and nothing imported from the measured program."""
