"""The inventory ops the port has not registered yet, by the JAX
package's op family they wait in (ROADMAP A23b).  Every name of
``inventory.OP_INVENTORY`` is in ``registry.OPS`` or here, never both
(``tests/test_torch_op_sweep.py``)."""

WAITING = {
    "misc": (  # 68
        "accuracy", "add_n", "all_gather", "all_reduce", "assign_out_",
        "assign_value", "assign_value_", "auc", "batch_norm_", "bce_loss",
        "broadcast", "cast", "class_center_sample", "clip_by_norm",
        "coalesce_tensor", "copy_to", "cross_entropy_with_softmax",
        "dirichlet", "divide_scalar", "dropout", "elementwise_pow",
        "exponential_", "fill", "fill_diagonal_tensor", "frobenius_norm",
        "full_", "full_batch_size_like", "gumbel_softmax", "hsigmoid_loss",
        "huber_loss", "i0e", "i1e", "kldiv_loss", "log_loss", "logsigmoid",
        "lu_unpack", "margin_cross_entropy", "masked_matmul",
        "matrix_rank_tol", "mean_all", "merge_selected_rows", "multiplex",
        "nextafter", "npu_identity", "p_norm", "p_recv", "p_recv_array",
        "pad3d", "reduce", "reduce_scatter", "renorm",
        "repeat_interleave_with_tensor_index", "reverse", "rrelu", "shape",
        "shard_index", "share_buffer", "sigmoid_cross_entropy_with_logits",
        "spectral_norm", "split_with_num", "squared_l2_norm",
        "sync_batch_norm_", "tanh_shrink", "thresholded_relu", "trans_layout",
        "tril_triu", "truncated_gaussian_random", "uniform_inplace",
    ),
    "vision": (  # 23
        "affine_grid", "bicubic_interp", "bilinear_interp", "box_coder",
        "channel_shuffle", "decode_jpeg", "deformable_conv",
        "distribute_fpn_proposals", "fold", "generate_proposals",
        "grid_sample", "linear_interp", "matrix_nms", "multiclass_nms3",
        "nearest_interp", "nms", "prior_box", "psroi_pool", "roi_align",
        "roi_pool", "trilinear_interp", "yolo_box", "yolo_loss",
    ),
    "optim": (  # 15
        "adadelta_", "adagrad_", "adam_", "adamax_", "adamw_",
        "average_accumulates_", "check_finite_and_unscale_", "fused_adam_",
        "lamb_", "merged_adam_", "merged_momentum_", "momentum_", "rmsprop_",
        "sgd_", "update_loss_scaling_",
    ),
    "fused": (  # 14
        "add_act_xpu", "conv2d_xpu", "embedding_with_eltwise_add_xpu",
        "fc_xpu", "flash_attn", "flash_attn_unpadded", "fused_attention",
        "fused_dropout_add", "fused_linear_param_grad_add",
        "fused_multi_transformer_xpu", "generate_sequence_xpu",
        "memory_efficient_attention", "multi_encoder_xpu", "yolo_box_xpu",
    ),
    "seq": (  # 8
        "edit_distance", "frame", "gather_tree", "overlap_add", "rnn",
        "viterbi_decode", "warpctc", "warprnnt",
    ),
    "sparse": (  # 6
        "coalesce", "sparse_coo_tensor", "to_dense", "to_sparse_coo",
        "to_sparse_csr", "values",
    ),
    "graph": (  # 6
        "reindex_graph", "segment_pool", "send_u_recv", "send_ue_recv",
        "send_uv", "weighted_sample_neighbors",
    ),
    "conv_extra": (  # 3
        "conv3d_transpose", "depthwise_conv2d", "depthwise_conv2d_transpose",
    ),
    "fft": (  # 3
        "fft_c2c", "fft_c2r", "fft_r2c",
    ),
}
