"""The benchmark of the PyTorch and CUDA port (``brax_tracking_tpu_torch``):
PPO training steps of the tracking envs on one NVIDIA H100. Run a cell with
``python3 portbench/run.py``; see README.md."""
