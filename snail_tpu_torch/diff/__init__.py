from .vjp import diff_closest_hit, render_loss_and_grads

__all__ = ["diff_closest_hit", "render_loss_and_grads"]
