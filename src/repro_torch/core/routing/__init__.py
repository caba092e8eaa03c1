from .discriminative import (DiscriminativeRouter, score_documents,
                             train_discriminative_router)
from .features import prefix_features
from .frequent import chunk_choices, evaluate_rerouted, per_token_nll
from .kmeans import (KMeansRouter, kmeans_assign, kmeans_fit,
                     product_kmeans_assign, product_kmeans_fit, topn_assign)

__all__ = ["DiscriminativeRouter", "KMeansRouter", "chunk_choices",
           "evaluate_rerouted", "kmeans_assign", "kmeans_fit",
           "per_token_nll", "prefix_features", "product_kmeans_assign",
           "product_kmeans_fit", "score_documents", "topn_assign",
           "train_discriminative_router"]
