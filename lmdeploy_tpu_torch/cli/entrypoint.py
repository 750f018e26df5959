"""CLI entrypoint: ``python -m lmdeploy_tpu_torch <command>``.

Port of ``lmdeploy_tpu/cli/entrypoint.py`` (reference analog: ``lmdeploy/cli/``): the
same command tree, chat / serve (api_server, launch_server, proxy) / lite / check_env,
plus ``--device`` on the engine commands (default: the GPU; ``cpu`` runs on the CPU).
``check_env`` reports torch, CUDA and nvcc; ``lite`` answers that the offline
quantization toolkit is not ported yet (ROADMAP item 17) and exits non-zero.
"""
from __future__ import annotations

import argparse


def _add_engine_args(parser):
    parser.add_argument('--tp', type=int, default=1, help='tensor parallel size')
    parser.add_argument('--dp', type=int, default=1, help='data parallel size')
    parser.add_argument('--dtype', default='auto',
                        choices=['auto', 'bfloat16', 'float16', 'float32'])
    parser.add_argument('--session-len', type=int, default=None)
    parser.add_argument('--max-batch-size', type=int, default=None)
    parser.add_argument('--block-size', type=int, default=64)
    parser.add_argument('--cache-max-entry-count', type=float, default=0.8)
    parser.add_argument('--quant-policy', type=int, default=0,
                        help='KV cache quant: 0 none, 4 int8, 8 int4, 16 fp8, '
                             '42 TurboQuant k4v2')
    parser.add_argument('--enable-prefix-caching', action='store_true')
    parser.add_argument('--max-prefill-token-num', type=int, default=8192)
    parser.add_argument('--device', default=None,
                        help='torch device (default: the GPU; cpu runs on the CPU)')


def _engine_config(args):
    from ..messages import TpuEngineConfig
    return TpuEngineConfig(
        dtype=args.dtype, tp=args.tp, dp=args.dp,
        session_len=args.session_len, max_batch_size=args.max_batch_size,
        block_size=args.block_size,
        cache_max_entry_count=args.cache_max_entry_count,
        quant_policy=args.quant_policy,
        enable_prefix_caching=args.enable_prefix_caching,
        max_prefill_token_num=args.max_prefill_token_num)


def cmd_chat(args):
    """Interactive terminal chat (reference: lmdeploy chat)."""
    from ..api import pipeline
    from ..messages import GenerationConfig
    pipe = pipeline(args.model_path, backend_config=_engine_config(args),
                    device=args.device)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens, do_sample=True,
                           temperature=args.temperature, top_p=args.top_p)
    session = None
    print('double-enter to send, "exit" to quit\n')
    try:
        while True:
            try:
                prompt = input('>>> ')
            except EOFError:
                break
            if prompt.strip() in ('exit', 'quit'):
                break
            if not prompt.strip():
                continue
            session = pipe.chat(prompt, session=session, gen_config=gen)
            print(session.response.text)
    finally:
        pipe.close()


def cmd_serve(args):
    from ..serve.api_server import serve
    serve(args.model_path, model_name=args.model_name,
          server_name=args.server_name, server_port=args.server_port,
          backend_config=_engine_config(args), api_key=args.api_key,
          device=args.device)


def cmd_check_env(args):
    import subprocess

    import torch
    print(f'torch: {torch.__version__}')
    print(f'CUDA runtime: {torch.version.cuda}')
    print(f'CUDA available: {torch.cuda.is_available()}')
    for i in range(torch.cuda.device_count()):
        print(f'device {i}: {torch.cuda.get_device_name(i)}')
    from ..ops import cuda_build
    try:
        nvcc = cuda_build._nvcc()
        res = subprocess.run([nvcc, '--version'], capture_output=True, text=True)
        print(f'nvcc: {nvcc}: {res.stdout.strip().splitlines()[-1]}')
    except RuntimeError:
        print('nvcc: not found (the CUDA kernels build with it at first use)')
    try:
        import transformers
        print(f'transformers: {transformers.__version__}')
    except ImportError:
        print('transformers: not installed')
    from ..models import supported_archs
    print(f'supported architectures: {supported_archs()}')


def cmd_lite(args):
    raise SystemExit(f'lite {args.lite_cmd}: the offline quantization toolkit is not '
                     f'ported yet (ROADMAP item 17)')


def cmd_proxy(args):
    from ..serve.proxy import proxy
    proxy(server_name=args.server_name, server_port=args.server_port,
          routing_strategy=args.routing_strategy,
          serving_strategy=args.serving_strategy)


def cmd_launch_server(args):
    from ..serve.launch_server import launch_server
    launch_server(args.model_path, num_ranks=args.num_ranks,
                  base_port=args.base_port, proxy_port=args.proxy_port,
                  routing_strategy=args.routing_strategy,
                  nnodes=args.nnodes, node_rank=args.node_rank,
                  coordinator=args.coordinator, proxy_url=args.proxy_url)


def build_parser():
    parser = argparse.ArgumentParser('lmdeploy_tpu_torch',
                                     description='LLM serving toolkit on PyTorch and CUDA')
    sub = parser.add_subparsers(dest='command', required=True)

    chat = sub.add_parser('chat', help='interactive chat in the terminal')
    chat.add_argument('model_path')
    chat.add_argument('--max-new-tokens', type=int, default=512)
    chat.add_argument('--temperature', type=float, default=0.8)
    chat.add_argument('--top-p', type=float, default=0.95)
    _add_engine_args(chat)
    chat.set_defaults(func=cmd_chat)

    serve_p = sub.add_parser('serve', help='OpenAI-compatible API server')
    serve_sub = serve_p.add_subparsers(dest='serve_cmd', required=True)
    api = serve_sub.add_parser('api_server')
    api.add_argument('model_path')
    api.add_argument('--model-name', default=None)
    api.add_argument('--server-name', default='0.0.0.0')
    api.add_argument('--server-port', type=int, default=23333)
    api.add_argument('--api-key', default=None)
    _add_engine_args(api)
    api.set_defaults(func=cmd_serve)

    # multi-rank launcher (reference: serve/openai/launch_server)
    launch = serve_sub.add_parser(
        'launch_server', help='N dp-rank servers (+ proxy on node 0)')
    launch.add_argument('model_path')
    launch.add_argument('--num-ranks', type=int, default=1)
    launch.add_argument('--base-port', type=int, default=23334)
    launch.add_argument('--proxy-port', type=int, default=8000)
    launch.add_argument('--routing-strategy', default='min_expected_latency')
    launch.add_argument('--nnodes', type=int, default=1)
    launch.add_argument('--node-rank', type=int, default=0)
    launch.add_argument('--coordinator', default=None,
                        help='multi-node coordinator host:port (not ported yet)')
    launch.add_argument('--proxy-url', default=None,
                        help='node 0 proxy URL (required on worker nodes)')
    launch.set_defaults(func=cmd_launch_server)

    # standalone cluster proxy (reference: lmdeploy serve proxy)
    prox = serve_sub.add_parser('proxy', help='cluster router/proxy server')
    prox.add_argument('--server-name', default='0.0.0.0')
    prox.add_argument('--server-port', type=int, default=8000)
    prox.add_argument('--routing-strategy', default='min_expected_latency',
                      choices=['random', 'min_expected_latency',
                               'min_observed_latency'])
    prox.add_argument('--serving-strategy', default='hybrid',
                      choices=['hybrid', 'distserve'],
                      help='hybrid: any node serves; distserve: PD-disaggregated')
    prox.set_defaults(func=cmd_proxy)

    lite = sub.add_parser('lite', help='offline quantization toolkit (not ported yet)')
    lite_sub = lite.add_subparsers(dest='lite_cmd', required=True)
    for name in ('auto_awq', 'auto_gptq', 'smooth_quant'):
        p = lite_sub.add_parser(name)
        p.add_argument('model')
        p.add_argument('--work-dir', default='./work_dir')
        p.add_argument('--w-bits', type=int, default=4)
        p.add_argument('--w-group-size', type=int, default=128)
        p.add_argument('--calib-samples', type=int, default=128)
        p.add_argument('--calib-seqlen', type=int, default=2048)
        p.set_defaults(func=cmd_lite)

    check = sub.add_parser('check_env', help='environment diagnostics')
    check.set_defaults(func=cmd_check_env)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    args.func(args)


if __name__ == '__main__':
    main()
