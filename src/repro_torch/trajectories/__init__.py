from repro_torch.trajectories.synthetic import (DISTRIBUTIONS, TrajectorySet,
                                                TrajectoryDistribution,
                                                corpus_splits, generate,
                                                ood_benchmark)

__all__ = ["DISTRIBUTIONS", "TrajectorySet", "TrajectoryDistribution",
           "corpus_splits", "generate", "ood_benchmark"]
