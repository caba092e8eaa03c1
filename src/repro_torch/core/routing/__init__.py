from .discriminative import (DiscriminativeRouter, score_documents,
                             train_discriminative_router)
from .features import prefix_features
from .kmeans import (kmeans_assign, kmeans_fit, product_kmeans_assign,
                     product_kmeans_fit, topn_assign)

__all__ = ["DiscriminativeRouter", "kmeans_assign", "kmeans_fit",
           "prefix_features", "product_kmeans_assign", "product_kmeans_fit",
           "score_documents", "topn_assign", "train_discriminative_router"]
