/* Plain C host of the port's embedded server (server_embed.h).
 *
 * The counterpart of native/tests/embed_smoke.c for the PyTorch port: init
 * the interpreter, create a server of the default zoo on the options'
 * device, run `simple` (a two-part v2 body, the sum/diff checked), then a
 * decoder_lm sequence: the prompt as the sequence start and STEPS greedy
 * steps, each feeding NEXT_TOKEN back (on the card each step launches
 * decode_attention once a layer). It prints each step's token and LOGITS
 * bytes in hex, so the caller can hold them against another run, then the
 * statistics JSON, checks the unknown-model error and destroys the server.
 *
 * Usage: embed_host <repo_path> <options_json> [steps] [prompt tokens...]
 *   e.g. embed_host . '{"models": ["simple", "decoder_lm"], "device": "cuda"}' 8 1 2 3 4
 * Exits 0 and prints "PASS embed_host" on success.
 */

#define _POSIX_C_SOURCE 199309L  /* clock_gettime under -std=c11 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "client_tpu/server_embed.h"

#define MAX_PROMPT 64
#define VOCAB 256

static int fail(const char* stage, char* error) {
  fprintf(stderr, "FAIL at %s: %s\n", stage,
          error != NULL ? error : "(no message)");
  ctpu_embed_free(error);
  return 1;
}

/* Offset and size of output `name`'s binary tail in a response whose JSON
 * header is header[0:header_len]: the tails follow the header in the order
 * of the outputs' entries, each of "binary_data_size" bytes. Returns 0 when
 * found. */
static int find_tail(const uint8_t* header, int64_t header_len, const char* name,
                     size_t* offset, size_t* size) {
  char* text = malloc((size_t)header_len + 1);
  memcpy(text, header, (size_t)header_len);
  text[header_len] = '\0';
  const char* cursor = strstr(text, "\"outputs\":[");
  size_t at = 0;
  int found = -1;
  while (cursor != NULL && found != 0) {
    const char* entry = strstr(cursor, "\"name\":\"");
    if (entry == NULL) break;
    entry += strlen("\"name\":\"");
    const char* end = strchr(entry, '"');
    const char* sized = strstr(entry, "\"binary_data_size\":");
    if (end == NULL || sized == NULL) break;
    size_t n = (size_t)strtoull(sized + strlen("\"binary_data_size\":"), NULL, 10);
    if ((size_t)(end - entry) == strlen(name) && strncmp(entry, name, strlen(name)) == 0) {
      *offset = at;
      *size = n;
      found = 0;
    }
    at += n;
    cursor = sized + 1;
  }
  free(text);
  return found;
}

/* One decoder_lm request: `count` tokens of sequence 1. Fills logits and
 * *next. Returns 0 on success. */
static int decode(int64_t server, const int32_t* tokens, int count, int start, int end,
                  float* logits, int32_t* next, char** error) {
  char header[512];
  int header_len = snprintf(
      header, sizeof(header),
      "{\"parameters\":{\"sequence_id\":1,\"sequence_start\":%s,\"sequence_end\":%s},"
      "\"inputs\":[{\"name\":\"TOKENS\",\"datatype\":\"INT32\",\"shape\":[1,%d],"
      "\"parameters\":{\"binary_data_size\":%d}}],"
      "\"outputs\":[{\"name\":\"LOGITS\",\"parameters\":{\"binary_data\":true}},"
      "{\"name\":\"NEXT_TOKEN\",\"parameters\":{\"binary_data\":true}}]}",
      start ? "true" : "false", end ? "true" : "false", count, 4 * count);
  size_t body_len = (size_t)header_len + 4 * (size_t)count;
  uint8_t* body = malloc(body_len);
  memcpy(body, header, (size_t)header_len);
  memcpy(body + header_len, tokens, 4 * (size_t)count);
  uint8_t* response = NULL;
  size_t response_len = 0;
  int64_t response_header_len = -1;
  int rc = ctpu_embed_infer(server, "decoder_lm", "", body, body_len, header_len,
                            &response, &response_len, &response_header_len, error);
  free(body);
  if (rc != 0) return rc;
  size_t logits_at = 0, logits_size = 0, next_at = 0, next_size = 0;
  if (response_header_len <= 0 ||
      find_tail(response, response_header_len, "LOGITS", &logits_at, &logits_size) != 0 ||
      find_tail(response, response_header_len, "NEXT_TOKEN", &next_at, &next_size) != 0 ||
      logits_size != 4 * VOCAB || next_size != 4 ||
      (size_t)response_header_len + next_at + next_size > response_len ||
      (size_t)response_header_len + logits_at + logits_size > response_len) {
    fprintf(stderr, "unexpected decoder_lm response framing: %.*s\n",
            (int)(response_header_len > 0 ? response_header_len : 0), response);
    ctpu_embed_free(response);
    return 1;
  }
  memcpy(logits, response + response_header_len + logits_at, logits_size);
  memcpy(next, response + response_header_len + next_at, 4);
  ctpu_embed_free(response);
  return 0;
}

static void print_step(int step, int32_t token, const float* logits) {
  const uint8_t* bytes = (const uint8_t*)logits;
  printf("step %d token %d logits ", step, token);
  for (size_t i = 0; i < 4 * VOCAB; i++) printf("%02x", bytes[i]);
  printf("\n");
}

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s <repo_path> <options_json> [steps] [prompt tokens...]\n",
            argv[0]);
    return 2;
  }
  const char* repo = argv[1];
  const char* options = argv[2];
  int steps = argc > 3 ? atoi(argv[3]) : 8;
  int32_t prompt[MAX_PROMPT] = {1, 2, 3, 4};
  int prompt_len = 4;
  if (argc > 4) {
    prompt_len = 0;
    for (int i = 4; i < argc && prompt_len < MAX_PROMPT; i++) prompt[prompt_len++] = atoi(argv[i]);
  }
  char* error = NULL;

  if (ctpu_embed_init(repo, &error) != 0) return fail("init", error);
  int64_t server = ctpu_embed_server_create(options, &error);
  if (server == 0) return fail("create", error);

  /* simple: two INT32[1,16] binary tails */
  int32_t input0[16], input1[16];
  for (int i = 0; i < 16; i++) {
    input0[i] = i;
    input1[i] = 2 * i;
  }
  const char* header_json =
      "{\"inputs\":["
      "{\"name\":\"INPUT0\",\"datatype\":\"INT32\",\"shape\":[1,16],"
      "\"parameters\":{\"binary_data_size\":64}},"
      "{\"name\":\"INPUT1\",\"datatype\":\"INT32\",\"shape\":[1,16],"
      "\"parameters\":{\"binary_data_size\":64}}],"
      "\"outputs\":["
      "{\"name\":\"OUTPUT0\",\"parameters\":{\"binary_data\":true}},"
      "{\"name\":\"OUTPUT1\",\"parameters\":{\"binary_data\":true}}]}";
  size_t header_len = strlen(header_json);
  size_t body_len = header_len + sizeof(input0) + sizeof(input1);
  uint8_t* body = malloc(body_len);
  memcpy(body, header_json, header_len);
  memcpy(body + header_len, input0, sizeof(input0));
  memcpy(body + header_len + sizeof(input0), input1, sizeof(input1));
  uint8_t* response = NULL;
  size_t response_len = 0;
  int64_t response_header_len = -1;
  int rc = ctpu_embed_infer(server, "simple", "", body, body_len, (int64_t)header_len,
                            &response, &response_len, &response_header_len, &error);
  free(body);
  if (rc != 0) return fail("simple", error);
  if (response_header_len <= 0 || (size_t)response_header_len + 128 != response_len) {
    fprintf(stderr, "FAIL: unexpected simple framing (header %lld of %zu)\n",
            (long long)response_header_len, response_len);
    return 1;
  }
  const int32_t* sum = (const int32_t*)(response + response_header_len);
  const int32_t* diff = sum + 16;
  for (int i = 0; i < 16; i++) {
    if (sum[i] != input0[i] + input1[i] || diff[i] != input0[i] - input1[i]) {
      fprintf(stderr, "FAIL: wrong arithmetic at %d: sum=%d diff=%d\n", i, sum[i], diff[i]);
      return 1;
    }
  }
  ctpu_embed_free(response);
  printf("ok simple (sum/diff verified)\n");

  /* decoder_lm: the prompt, then `steps` greedy tokens fed back */
  float logits[VOCAB];
  int32_t token = 0;
  struct timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  if (decode(server, prompt, prompt_len, 1, steps == 0, logits, &token, &error) != 0)
    return fail("decoder_lm prompt", error);
  print_step(0, token, logits);
  for (int i = 0; i < steps; i++) {
    int32_t fed = token;
    if (decode(server, &fed, 1, 0, i == steps - 1, logits, &token, &error) != 0)
      return fail("decoder_lm step", error);
    print_step(i + 1, token, logits);
  }
  clock_gettime(CLOCK_MONOTONIC, &t1);
  printf("decode_ms %.3f\n",
         (t1.tv_sec - t0.tv_sec) * 1e3 + (t1.tv_nsec - t0.tv_nsec) / 1e6);

  char* json = NULL;
  if (ctpu_embed_statistics(server, "", &json, &error) != 0) return fail("statistics", error);
  printf("statistics %s\n", json);
  ctpu_embed_free(json);

  /* error path: an unknown model fails cleanly */
  rc = ctpu_embed_infer(server, "no_such_model", "", (const uint8_t*)"{}", 2, -1,
                        &response, &response_len, &response_header_len, &error);
  if (rc == 0) {
    fprintf(stderr, "FAIL: unknown model inference succeeded\n");
    return 1;
  }
  printf("ok typed error on unknown model: %s\n", error);
  ctpu_embed_free(error);
  error = NULL;

  if (ctpu_embed_server_destroy(server, &error) != 0) return fail("destroy", error);
  printf("PASS embed_host\n");
  return 0;
}
