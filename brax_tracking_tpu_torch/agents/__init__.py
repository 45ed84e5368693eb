"""Learning agents of the port (PPO)."""
