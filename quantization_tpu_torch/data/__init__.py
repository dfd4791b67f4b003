from .synthetic import gaussian_sampler, make_mlp_sampler, shannon_distortion

__all__ = ["gaussian_sampler", "make_mlp_sampler", "shannon_distortion"]
